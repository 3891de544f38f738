"""Input for the port: the CLIP tokenizer and the synthetic dataset."""
