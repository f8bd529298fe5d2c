"""Models of the port (the NMT encoder-decoder, inference half)."""
