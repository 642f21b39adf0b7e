"""Training checkpoints with rotation and resume, in torch's format.

Counterpart: `diffcodec_tpu/train/checkpoint.py` (the reference's
`accelerator.save_state('checkpoint-{step}')` with
`checkpoints_total_limit` rotation, `train_controlnet.py:1174-1197`, and
its `--resume_from_checkpoint latest`): the same `checkpoint-N` directory
names and rotation policy; the state is one `torch.save` file,
`checkpoint-N/state.pt`, where the JAX package writes an Orbax tree.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
STATE_FILE = "state.pt"


def list_checkpoints(ckpt_dir: str):
    """Sorted (step, path) list of the checkpoint-N directories."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    total_limit: Optional[int] = None) -> str:
    """Save `state` (tensors in nested dicts, lists and numbers) as
    checkpoint-{step}, moved to the CPU; where `total_limit` checkpoints
    exist already, delete the oldest so that the new one keeps the count at
    the limit.  Saving a step again replaces it without rotating others.
    In a process group every rank calls it and rank 0 writes (the others
    wait for it)."""
    import torch.distributed as dist

    from diffcodec_tpu_torch.parallel.mesh import is_writer

    path = os.path.join(ckpt_dir, f"checkpoint-{step}")
    if is_writer():
        _write(ckpt_dir, step, state, total_limit)
    if dist.is_initialized():
        dist.barrier()
    return path


def _write(ckpt_dir: str, step: int, state: Any,
           total_limit: Optional[int]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    existing = [(s, p) for s, p in list_checkpoints(ckpt_dir) if s != step]
    if total_limit is not None and len(existing) >= total_limit:
        for _, path in existing[:len(existing) - total_limit + 1]:
            shutil.rmtree(path, ignore_errors=True)
    path = os.path.join(ckpt_dir, f"checkpoint-{step}")
    if os.path.exists(path):
        shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    cpu = _map_tensors(state, lambda t: t.detach().cpu())
    # write under a private name and rename: a cut save leaves no state.pt
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(cpu, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location="cpu"):
    """(state, step) of checkpoint-{step}, the latest where step is None,
    or (None, 0) where there is none.  The file is memory-mapped (private
    pages): a tensor is read where it is used, so a caller that takes one
    part of the state (the decode CLIs, a distilled run's EMA) reads no
    more of it."""
    existing = list_checkpoints(ckpt_dir)
    if step is not None:
        existing = [(s, p) for s, p in existing if s == step]
    if not existing:
        return None, 0
    step, path = existing[-1]
    state = torch.load(os.path.join(path, STATE_FILE),
                       map_location=map_location, weights_only=True,
                       mmap=True)
    return state, step


def warm_start_filter(params: Dict[str, torch.Tensor],
                      loaded: Dict[str, torch.Tensor]):
    """Shape-filtered warm start (`train_controlnet.py:822-832`): take the
    loaded tensor where the name and shape match, keep the fresh one
    elsewhere.  Returns (params, number copied)."""
    out, copied = {}, 0
    for name, p in params.items():
        cand = loaded.get(name)
        if cand is not None and tuple(cand.shape) == tuple(p.shape):
            out[name] = cand
            copied += 1
        else:
            out[name] = p
    return out, copied


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree
