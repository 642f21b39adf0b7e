"""The SD-1.5 model family: UNet, DualFlowControlNet and ResControlNet with
their extractors, VAE, CLIP text encoder, the residual DDPM's UNet2DModel
and the CMP densifier."""
