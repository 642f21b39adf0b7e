"""Host-side utilities of the port: the CLIP tokenizer, the safetensors
file format and .flo flow files."""
