"""Command-line drivers of the port: the counterparts of the JAX
package's ``examples/*.py``, with the same flags, defaults and printed
lines, plus ``--device`` (default ``cuda``; ``cpu`` runs them on the
host). Run one as ``python -m parallax_tpu_torch.examples.<name>``;
each module's ``main(argv=None)`` takes the arguments as a list too.

* ``simple_driver`` — the linear-regression smoke;
* ``lm1b_driver`` / ``lm1b_eval`` — LM1B training (``--lstm_impl pallas``
  runs the CUDA LSTM kernels) and its full-softmax perplexity;
* ``nmt_driver`` / ``nmt_eval`` — the transformer NMT and its greedy or
  beam decode scored with corpus BLEU;
* ``long_context_driver`` — the causal LM with ring, tensor, pipeline or
  data parallelism;
* ``cnn_benchmark_driver`` / ``cnn_eval`` — the CNN zoo and its top-1
  accuracy with the running BatchNorm statistics;
* ``skip_thoughts_driver`` — skip-thoughts with file-level sharding.

The eval scripts restore through ``checkpoint.restore_train_state``,
which reads the JAX package's on-disk format: a checkpoint either
package wrote evaluates here.
"""
