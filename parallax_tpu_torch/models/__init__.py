"""Models of the port: LM1B, NMT, BERT, the long-context causal LM, the
CNNs and the linear regression."""
