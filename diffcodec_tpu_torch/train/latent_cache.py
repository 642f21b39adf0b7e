"""Latent-moments cache: skip the frozen VAE encoder in the training step.

Counterpart: `diffcodec_tpu/train/latent_cache.py`.  The encoder is frozen
and its posterior a diagonal Gaussian, so each sample's moments (mean ++
logvar, 2 * latent_channels channels at H/8) can be computed once; the step
then draws mean + exp(logvar / 2) * eps, the same math as the online
encode.  The pixels must be the ones the step would see, so the wrapped
dataset must not augment them (`transform` false).

Storage, shared with the JAX package so that a cache written by either
reads in the other: one float32 `moments_%08d.npy` per sample index and a
`latent_cache_meta.json` with the count and the moments' shape.  bf16 ->
fp32 -> bf16 is exact, so the file adds no rounding to a bf16 encode.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

_META = "latent_cache_meta.json"


def _moments_path(cache_dir: str, index: int) -> str:
    return os.path.join(cache_dir, f"moments_{index:08d}.npy")


def _check_deterministic(dataset):
    if getattr(dataset, "transform", False):
        raise ValueError(
            "latent caching requires deterministic pixels: construct the "
            "dataset with transform=False (ColorJitter changes the image "
            "per draw, which would make the cache stale by construction)")


@torch.no_grad()
def precompute_latent_moments(vae, dataset, cache_dir: str,
                              batch_size: int = 8,
                              over_ranks: bool = False) -> int:
    """Encode every sample of `dataset` (indexable; samples hold an
    'image' [H, W, 3] in [-1, 1], or a 'residual', which the trainer then
    encodes instead) once with `vae` on its device and dtype, and store the
    moments.  Returns the number of samples in the cache.

    With `over_ranks` every rank of the process group calls it and
    encodes every world-th batch; rank 0 writes the count once all have
    written theirs, and no rank returns before that.  No rank waits for
    long: the shares differ by at most a batch.  Every rank still reads
    every sample, so the dataset's draws (a caption dropped or kept per
    read) advance on each as in one process and the training batches that
    follow are the same on every rank."""
    import torch.distributed as dist

    _check_deterministic(dataset)
    os.makedirs(cache_dir, exist_ok=True)
    rank, world = ((dist.get_rank(), dist.get_world_size()) if over_ranks
                   else (0, 1))
    w = vae.quant_conv.weight
    n = len(dataset)
    shape = None
    for s0 in range(0, n, batch_size):
        idx = range(s0, min(s0 + batch_size, n))
        samples = [dataset[i] for i in idx]
        if (s0 // batch_size) % world != rank:
            continue
        imgs = np.stack([s.get("residual", s["image"]) for s in samples])
        mean, logvar = vae.encode(torch.from_numpy(imgs).to(w.device,
                                                             w.dtype))
        moments = torch.cat([mean, logvar], dim=-1).float().cpu().numpy()
        for k, i in enumerate(idx):
            np.save(_moments_path(cache_dir, i), moments[k])
        shape = list(moments[0].shape)
    if world > 1:
        dist.barrier()
    if rank == 0:
        with open(os.path.join(cache_dir, _META), "w") as f:
            json.dump({"count": n, "moments_shape": shape}, f)
    if world > 1:
        dist.barrier()
    return n


def cache_complete(cache_dir: str, n: int) -> bool:
    meta = os.path.join(cache_dir, _META)
    if not os.path.exists(meta):
        return False
    with open(meta) as f:
        return json.load(f).get("count") == n


class LatentCachedDataset:
    """An indexable dataset with 'latent_moments' added to each sample; the
    trainer's `loss_fn` then skips the encoder.  Other keys and attributes
    pass through."""

    def __init__(self, dataset, cache_dir: str):
        _check_deterministic(dataset)
        if not cache_complete(cache_dir, len(dataset)):
            raise FileNotFoundError(
                f"latent cache at {cache_dir!r} is missing or incomplete; "
                "run precompute_latent_moments first")
        self.dataset = dataset
        self.cache_dir = cache_dir

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sample = dict(self.dataset[index])
        sample["latent_moments"] = np.load(
            _moments_path(self.cache_dir, index))
        return sample

    def __getattr__(self, name):
        return getattr(self.dataset, name)
