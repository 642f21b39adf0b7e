"""Two of the port's CPU roundings that depend on the host, held to fixed
bounds with no JAX in the file, so that they can be read on any machine:

  python -m pytest --noconftest -q -s tests/test_torch_port_host_numerics.py

prints each reading.  `tests/test_torch_port_distilled.py::
test_boundary_scalings_match_jax` and `tests/test_torch_port_train.py::
test_latent_caches_read_across_packages` hold the same quantities beside
JAX's, where JAX is installed.
"""

import numpy as np
import torch

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch.models.vae import AutoencoderKL
from diffcodec_tpu_torch.train import distill as tdistill


def test_boundary_scalings_c_out_within_two_ulps_of_float64():
    """c_out = s / sqrt(s^2 + 0.25) in fp32 against the float64 value
    rounded to fp32, in its ulps: three fp32 roundings, each half an ulp
    when correctly rounded; the vectorised CPU kernels read 2 ulps on one
    host (torch 2.13.0+cpu) and 1 on the card machine's (torch
    2.11.0+cu128)."""
    ts = np.arange(0, 1000, dtype=np.int32)
    c_skip, c_out = tdistill.boundary_scalings(torch.from_numpy(ts))
    s = (ts.astype(np.float32) * np.float32(0.01)).astype(np.float64)
    exact = (s / np.sqrt(s ** 2 + 0.25)).astype(np.float32)
    err = (np.abs(c_out.numpy().astype(np.float64) - exact)
           / np.spacing(exact))
    print(f"c_out: {err.max()} ulps at most, {(err > 0).sum()} of 1000 off")
    assert err.max() <= 2
    assert float(c_skip[0]) == 1.0 and float(c_out[0]) == 0.0


def test_encoder_batch_split_within_bound():
    """The tiny VAE encoder on 3 images at once against the same images in
    batches of 2 and 1 (the latent cache's writer), fp32: the CPU's convs
    may round a sample apart with its batch (7.2e-7 at most on one host,
    torch 2.13.0+cpu, 1.5e-6 with the weights of test_torch_port_train.py;
    0 on the card machine's, torch 2.11.0+cu128)."""
    torch.manual_seed(0)
    vae = AutoencoderKL(tcfg.VAEConfig(base_channels=8,
                                       channel_mults=(1, 1, 2, 2),
                                       layers_per_block=1))
    images = torch.from_numpy(np.random.default_rng(21).uniform(
        -1, 1, (3, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        whole = torch.cat(vae.encode(images), dim=-1)
        split = torch.cat([torch.cat(vae.encode(images[s]), dim=-1)
                           for s in (slice(0, 2), slice(2, 3))])
    diff = (whole - split).abs().max().item()
    print(f"encoder batch split: {diff} at most")
    assert diff <= 1e-5 * whole.abs().max().item()
