"""UniPC sampling and the decode pipelines; the residual DDPM's step."""
