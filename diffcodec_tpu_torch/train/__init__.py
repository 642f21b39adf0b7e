"""Training-side code of the port: the ControlNet trainer (the DualFlow and
residual variants), its losses and the LPIPS network, the consistency
distillation trainer of the K-step student, checkpoints and latent cache,
the dataset loader and its prefetcher, the residue transform and the
residual DDPM's step."""
