"""Command-line entry points of the port: the codec (`python -m
diffcodec_tpu_torch.cli.run_codec`, `.rd_sweep`), the distillation trainer
and its quality gate (`.train_distill`, `.distill_eval`) and the residual
DDPM's trainer (`.train_residual`)."""
