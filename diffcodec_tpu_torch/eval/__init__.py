"""The codec's evaluation layer (counterpart of `diffcodec_tpu/eval/`):
PSNR / SSIM / MS-SSIM, the FID-64 Inception prefix, the Fréchet distances
(FID, FVD), BD-rates over the published anchors, the per-video codec
evaluation, plots and the frequency-band study."""
