"""Training-side code of the port: the ControlNet trainer, its losses,
checkpoints and latent cache, and the helpers of the decoder's step
distillation (whose trainer is not ported yet)."""
