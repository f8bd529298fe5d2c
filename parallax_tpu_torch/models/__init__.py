"""Models of the port: LM1B, NMT, BERT, the long-context causal LM, the
switch-MoE LM, skip-thoughts, the CNNs and the linear regression."""
