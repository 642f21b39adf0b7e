"""Host-side utilities of the port: the CLIP tokenizer."""
