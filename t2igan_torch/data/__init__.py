"""Input for the port: the CLIP tokenizer, the synthetic dataset, the
reference's on-disk datasets with their loader, and the image decoder."""
