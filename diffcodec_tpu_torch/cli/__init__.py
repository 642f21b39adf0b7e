"""Command-line entry points of the port (`python -m
diffcodec_tpu_torch.cli.run_codec`, `python -m
diffcodec_tpu_torch.cli.rd_sweep`)."""
