"""Training-side code of the port: the ControlNet trainer (the DualFlow and
residual variants), its losses and the LPIPS network, the consistency
distillation trainer of the K-step student, checkpoints and latent cache,
the dataset loader and its prefetcher, the residue transform, the
residual DDPM's step, and the CMP's trainer and experiment configs."""
