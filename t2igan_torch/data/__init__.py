"""Text input for the port: the CLIP tokenizer."""
