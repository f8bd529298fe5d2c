"""The engine of the port: variable specs, the ``('repl', 'shard')``
mesh over the ranks, the dense/sparse classifier, the optimizer chain
and the train step."""
