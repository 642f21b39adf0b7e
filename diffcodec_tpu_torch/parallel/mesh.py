"""The data x fsdp device mesh on torch.distributed, and the fsdp layout
of the trainers' states.

Counterpart: `diffcodec_tpu/parallel/mesh.py` (`init_distributed` :25,
`make_mesh` :45, `_fsdp_spec` :68, `param_shardings` :85, `shard_batch`
:97).  The reference trains with DDP plus DeepSpeed ZeRO-1/2
optimizer-state sharding; the JAX package expresses both as one
`jax.sharding.Mesh` with axes

    data  batch rows (the GOP's inter frames, 1080p tiles, the train batch)
    fsdp  the fp32 master parameters and the optimizer's state

and XLA inserts the collectives.  Here one process drives one device
(`torchrun --nproc_per_node N`), rank = data_rank * fsdp + fsdp_rank as
JAX reshapes its devices, and the collectives are explicit
(`FsdpLayout`): the gradients are averaged over the data ranks, each fsdp
rank updates its slice of the masters and the moments, and the working
copies are gathered back.  NCCL on CUDA devices, gloo where the caller asks
for the CPU; neither falls back to the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from diffcodec_tpu_torch.config import MeshConfig

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(device="cuda") -> Tuple[int, int]:
    """Join the process group torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return (rank, world size).
    NCCL for a CUDA device, whose index becomes LOCAL_RANK; gloo for the
    CPU.  Returns the group's numbers where one is joined already; raises
    where there is no torchrun environment."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"no process group to join ({', '.join(missing)} "
                           f"unset): launch with torchrun --nproc_per_node")
    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    dist.init_process_group(backend)
    return dist.get_rank(), dist.get_world_size()


def is_writer() -> bool:
    """Rank 0 of the process group, or the one process: the one that
    writes checkpoints, logs and validation panels."""
    return not dist.is_initialized() or dist.get_rank() == 0


def mesh_shape(cfg: MeshConfig, n: int) -> Tuple[int, int]:
    """(data, fsdp) for `n` devices, with the JAX package's errors."""
    fsdp = max(1, cfg.fsdp_size)
    if n % fsdp:
        raise ValueError(f"{n} devices not divisible by fsdp={fsdp}")
    data = cfg.data_size if cfg.data_size > 0 else n // fsdp
    if data * fsdp != n:
        raise ValueError(f"mesh {data}x{fsdp} != {n} devices")
    return data, fsdp


@dataclasses.dataclass(eq=False)
class Mesh:
    """The process group as a (data, fsdp) grid: this rank's coordinates
    and the groups along each axis (`device_mesh`, a torch DeviceMesh
    with those dimension names)."""
    device_mesh: object
    axis_names: Tuple[str, str]
    data_size: int
    fsdp_size: int
    data_rank: int
    fsdp_rank: int

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (self.data_size, self.fsdp_size)))

    @property
    def data_group(self):
        return self.device_mesh.get_group(self.axis_names[0])

    @property
    def fsdp_group(self):
        return self.device_mesh.get_group(self.axis_names[1])


def make_mesh(cfg: MeshConfig = MeshConfig(), device="cuda") -> Mesh:
    """The (data, fsdp) mesh over the process group's ranks (joined with
    `init_distributed(device)` where it is not yet)."""
    from torch.distributed.device_mesh import init_device_mesh

    _, world = init_distributed(device)
    data, fsdp = mesh_shape(cfg, world)
    names = (cfg.data_axis, cfg.fsdp_axis)
    dm = init_device_mesh(torch.device(device).type, (data, fsdp),
                          mesh_dim_names=names)
    return Mesh(dm, names, data, fsdp, dm.get_local_rank(names[0]),
                dm.get_local_rank(names[1]))


def join_mesh(fsdp: int, device="cuda") -> Optional[Mesh]:
    """The CLIs' `--fsdp`: the data x fsdp mesh with `fsdp` ranks on the
    fsdp axis where the process was started by torchrun (or is in a group
    already), joined on `device`; None in a single process, where `fsdp`
    must be 1."""
    if dist.is_initialized() or all(k in os.environ for k in _TORCHRUN_ENV):
        return make_mesh(MeshConfig(fsdp_size=fsdp), device)
    if fsdp != 1:
        raise SystemExit(f"--fsdp {fsdp} runs on the data x fsdp mesh, one "
                         f"process a device: launch with torchrun "
                         f"--nproc_per_node")
    return None


def _fsdp_spec(shape, fsdp_axis: str, fsdp_size: int) -> tuple:
    """The JAX package's rule on a tensor's shape: split the largest
    dimension that the fsdp axis size divides (the first of equal ones),
    as a spec naming that dimension's axis ((None, 'fsdp', None, ...));
    () (replicated) for scalars, for fsdp size 1 and where none divides."""
    if fsdp_size <= 1 or not shape:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
            spec = [None] * len(shape)
            spec[i] = fsdp_axis
            return tuple(spec)
    return ()


def param_shardings(mesh: Mesh, params: Mapping[str, torch.Tensor]
                    ) -> Dict[str, tuple]:
    """`_fsdp_spec` of each tensor of a parameter dict, by name."""
    return {n: _fsdp_spec(tuple(p.shape), mesh.axis_names[1],
                          mesh.fsdp_size) for n, p in params.items()}


def batch_rows(mesh: Optional[Mesh], n: int) -> Optional[slice]:
    """This data rank's rows of a global batch of `n`, or None where the
    data axis does not divide it (the batch is then replicated)."""
    if mesh is None or mesh.data_size == 1 or n % mesh.data_size:
        return None
    per = n // mesh.data_size
    return slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)


def shard_batch(mesh: Optional[Mesh], batch: Mapping) -> dict:
    """This data rank's rows of each leaf of a global batch (tensors or
    numpy arrays, batch first); leaves whose batch does not divide by the
    data axis stay whole (replicated), as JAX's `shard_batch` leaves
    them.  The batch itself where there is no mesh."""
    if mesh is None:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        rows = batch_rows(mesh, v.shape[0]) if getattr(v, "ndim", 0) else None
        out[k] = v if rows is None else v[rows]
    return out


def row_taker(layout: Optional["FsdpLayout"], n: int):
    """x -> this data rank's rows of `x`, a tensor of a global batch of
    `n` (a draw, or a leaf of the batch); x itself in one process and
    where the data axis does not divide `n` (the batch is then replicated,
    and every rank steps on all of it)."""
    rows = None if layout is None else batch_rows(layout.mesh, n)
    if rows is None:
        return lambda x: x
    return lambda x: x[rows]


class FsdpLayout:
    """The fsdp split of a set of named tensors (the masters, and so their
    moments, accumulators and EMA): each tensor's `_fsdp_spec` dimension
    cut into fsdp_size equal slices, slice i on fsdp rank i; the others
    whole on every rank."""

    def __init__(self, mesh: Mesh, shapes: Mapping[str, torch.Size]):
        self.mesh = mesh
        self.dims = {}
        for n, shape in shapes.items():
            spec = _fsdp_spec(tuple(shape), mesh.axis_names[1],
                              mesh.fsdp_size)
            self.dims[n] = spec.index(mesh.axis_names[1]) if spec else None

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor (a copy, so the whole one can
        be freed); a tensor kept whole is returned as it is."""
        d = self.dims[name]
        if d is None:
            return t
        return t.chunk(self.mesh.fsdp_size, d)[self.mesh.fsdp_rank].clone()

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's slice (an all-gather over
        the fsdp ranks)."""
        d = self.dims[name]
        if d is None or self.mesh.fsdp_size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mesh.fsdp_size)]
        dist.all_gather(parts, t, group=self.mesh.fsdp_group)
        return torch.cat(parts, d)

    def shard_dict(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        return {n: self.shard(n, t) for n, t in tensors.items()}

    def gather_dict(self, tensors: Mapping[str, torch.Tensor]) -> dict:
        return {n: self.gather(n, t) for n, t in tensors.items()}

    def mean_over_data(self, grads: Mapping[str, torch.Tensor]) -> dict:
        """The gradients averaged over the data ranks (each rank's are
        those of its rows' mean loss), in fp32; as they are where the data
        axis is 1 (the optimizer widens each as it uses it)."""
        if self.mesh.data_size == 1:
            return dict(grads)
        out = {n: g.float() for n, g in grads.items()}
        for g in out.values():
            dist.all_reduce(g, group=self.mesh.data_group)
            g.div_(self.mesh.data_size)
        return out

    def sq_norm(self, shards: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The squared global norm of a gradient held as slices: each
        rank's sum of squares (a whole tensor counted on fsdp rank 0
        only), summed over the fsdp ranks."""
        first = self.mesh.fsdp_rank == 0
        total = sum(torch.sum(g.float() ** 2) for n, g in shards.items()
                    if first or self.dims[n] is not None)
        total = torch.as_tensor(total, dtype=torch.float32,
                                device=next(iter(shards.values())).device)
        if self.mesh.fsdp_size > 1:
            dist.all_reduce(total, group=self.mesh.fsdp_group)
        return total

    def mean_metrics(self, metrics: Mapping[str, torch.Tensor]) -> dict:
        """Each metric averaged over the data ranks: the global batch's
        mean where each rank reports its rows' mean."""
        if self.mesh.data_size == 1:
            return dict(metrics)
        out = {}
        for k, v in metrics.items():
            v = v.detach().float().clone()
            dist.all_reduce(v, group=self.mesh.data_group)
            out[k] = v / self.mesh.data_size
        return out
