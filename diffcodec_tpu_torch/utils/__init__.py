"""Host-side utilities of the port: the CLIP tokenizer, the safetensors
file format, .flo flow files and the training CLIs' logging."""
