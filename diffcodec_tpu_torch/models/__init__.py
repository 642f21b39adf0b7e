"""The SD-1.5 models of the decode path: UNet, DualFlowControlNet with its
feature extractor, VAE decoder."""
