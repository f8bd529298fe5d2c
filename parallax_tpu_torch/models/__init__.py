"""Models of the port: LM1B (training) and the NMT encoder-decoder
(inference half)."""
