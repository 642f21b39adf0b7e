"""Training-side code of the port: the ControlNet trainer (the DualFlow and
residual variants), its losses and the LPIPS network, checkpoints and
latent cache, the residue transform and the residual DDPM's step, and the
helpers of the decoder's step distillation (whose trainer is not ported
yet)."""
