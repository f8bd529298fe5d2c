"""The engine of the port: variable specs, the one-card mesh record,
the dense/sparse classifier, the optimizer chain and the train step."""
