"""The SD-1.5 model family: UNet, DualFlowControlNet and ResControlNet with
their extractors, VAE, CLIP text encoder, the residual DDPM's UNet2DModel,
the CMP densifier and I3D (FVD); `weights` reads and writes their
checkpoint files."""
