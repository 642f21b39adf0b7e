"""Multi-process dry run of the data x fsdp mesh, at tiny sizes.

Counterpart: `__graft_entry__.dryrun_multichip` (:63-277).  Run under
torchrun, one process a device (gloo on the CPU with `--device cpu`, NCCL
on the cards):

  torchrun --nproc_per_node 4 -m diffcodec_tpu_torch.parallel.dryrun \\
      --device cpu

It builds a data x fsdp mesh (fsdp 2 where the world size is even), then
runs five paths with tiny models, their weights seeded alike on every
rank:
  train     one sharded ControlNet step (`ControlNetTrainer.shard_state`)
  decode    a GOP batch of frames decoded by `DualFlowPipeline.sample`,
            each data rank its rows, gathered
  distill   one sharded consistency-distillation step (student, EMA and
            moments split over the fsdp ranks)
  tiled     the 15 tiles of a frame larger than the tile (1080p's count),
            padded to the data axis (15 -> 16), sampled over it, gathered
            and merged
  sparse    the codec's sparse-mode decode: the flow bitstreams densified
            by a CMP, `decode_inter_frames` with each chunk split over the
            data axis
and prints one JSON line with each path's numbers and kernel launches (0
on the CPU, where the kernels' plain versions run).
"""

from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from diffcodec_tpu_torch.ops.launches import count_launches as counted

H = 32                         # the training and decode frames' size
HD_H, HD_W, TILE, OVERLAP = 48, 80, 32, 16   # 15 tiles


def tiny_models(device, seed: int = 0):
    """fp32 tiny UNet, DualFlowControlNet and fused-conv VAE (the CLIs'
    `--tiny` configs), initialised from `seed` on the CPU (the same
    weights on every rank) and moved to `device`."""
    from diffcodec_tpu_torch.cli.run_codec import model_configs
    from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
    from diffcodec_tpu_torch.models.unet2d_condition import (
        UNet2DConditionModel)
    from diffcodec_tpu_torch.models.vae import AutoencoderKL

    unet_cfg, cn_cfg, vae_cfg, _ = model_configs(True)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        models = (UNet2DConditionModel(unet_cfg), DualFlowControlNet(cn_cfg),
                  AutoencoderKL(vae_cfg, fused_conv=True))
    return tuple(m.to(device) for m in models)


def tiny_batch(B: int, ctx_dim: int, device, seed: int = 1) -> dict:
    """A training batch: images and conditioning uniform, flows ~ 2 N(0,
    1) px, text embeddings ~ 0.1 N(0, 1), uncond zeros."""
    g = torch.Generator().manual_seed(seed)
    batch = dict(image=torch.rand((B, H, H, 3), generator=g) * 2 - 1,
                 cond=torch.rand((B, H, H, 6), generator=g),
                 flow=torch.randn((B, H, H, 4), generator=g) * 2,
                 text_embeds=torch.randn((B, 5, ctx_dim), generator=g) * 0.1)
    batch["uncond_embeds"] = torch.zeros_like(batch["text_embeds"])
    return {k: v.to(device) for k, v in batch.items()}


def train_config(lr: float = 1e-4):
    from diffcodec_tpu_torch.config import TrainConfig
    return TrainConfig(learning_rate=lr, lr_warmup_steps=0,
                       max_train_steps=10)


def controlnet_trainer(models, dtype=torch.float32, lr: float = 1e-4):
    """(trainer, state): AdamW over the ControlNet's fp32 masters, the
    models in `dtype`."""
    from diffcodec_tpu_torch.config import SchedulerConfig
    from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
    from diffcodec_tpu_torch.train.trainer import (ControlNetTrainer,
                                                   Optimizer, TrainState)

    unet, controlnet, vae = models
    state = TrainState.create(dict(controlnet.named_parameters()),
                              Optimizer(train_config(lr)))
    trainer = ControlNetTrainer(
        unet=unet.to(dtype).eval(), controlnet=controlnet.to(dtype),
        vae=vae.to(dtype).eval(),
        schedule=NoiseSchedule.create(SchedulerConfig()),
        config=train_config(lr))
    return trainer, state


def distiller(models, dtype=torch.float32, lr: float = 1e-4):
    """(distiller, state) warm-started from `models`: 10 teacher steps, no
    FreeU, EMA decay 0.9 (the JAX dry run's DistillConfig)."""
    from diffcodec_tpu_torch.config import DistillConfig, SchedulerConfig
    from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
    from diffcodec_tpu_torch.train.distill import ConsistencyDistiller
    from diffcodec_tpu_torch.train.trainer import Optimizer

    return ConsistencyDistiller.create(
        *models, NoiseSchedule.create(SchedulerConfig()),
        DistillConfig(num_teacher_steps=10, freeu=False, ema_decay=0.9),
        Optimizer(train_config(lr)), dtype)


def gather_rows(mesh, t: torch.Tensor) -> torch.Tensor:
    """The data ranks' rows of a batch, concatenated in rank order."""
    if mesh.data_size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.data_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts)


def over_data(mesh, fn, *tensors):
    """fn on this data rank's rows of `tensors` (a batch the data axis
    divides), the results gathered in rank order."""
    from diffcodec_tpu_torch.parallel.mesh import batch_rows
    rows = batch_rows(mesh, tensors[0].shape[0])
    if rows is None:
        return fn(*tensors)
    return gather_rows(mesh, fn(*(t[rows] for t in tensors)))


def run(mesh, device) -> dict:
    """The five paths on `mesh` (see the module's docstring), the models
    in bf16 as the JAX package's dry run has them; returns {path:
    {numbers..., "launches": {kernel: n}}}."""
    from diffcodec_tpu_torch.cli.train_distill import step_generator
    from diffcodec_tpu_torch.codec.gop import gop_schedule
    from diffcodec_tpu_torch.codec.runner import (EncodedVideo,
                                                  decode_inter_frames,
                                                  encode_flows,
                                                  make_cmp_densifier)
    from diffcodec_tpu_torch.config import SamplerConfig
    from diffcodec_tpu_torch.models.cmp import CMP
    from diffcodec_tpu_torch.ops.tiling import merge_tiles
    from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
    from diffcodec_tpu_torch.sampling.tiled import _crop_batch, tile_grid

    dtype = torch.bfloat16
    out = {}
    world = mesh.data_size * mesh.fsdp_size
    B = max(world, 2)
    trainer, state = controlnet_trainer(tiny_models(device), dtype)
    ctx = trainer.unet.cfg.cross_attention_dim
    batch = tiny_batch(B, ctx, device)
    state = trainer.shard_state(mesh, state)
    (state, metrics), n = counted(lambda: trainer.train_step(
        state, batch, step_generator(0, 0, device)))
    loss = metrics["loss_mse"].item()
    assert np.isfinite(loss), loss
    out["train"] = dict(loss_mse=loss, batch=B, launches=n)

    # the GOP's frames decoded over the data axis, the ControlNet's
    # working copy as trained
    pipe = DualFlowPipeline(
        unet=trainer.unet, controlnet=trainer.controlnet, vae=trainer.vae,
        schedule=trainer.schedule,
        sampler=SamplerConfig(num_inference_steps=2, guidance_scale=2.0,
                              freeu=False))
    g = torch.Generator().manual_seed(2)
    latents = torch.randn((B, H // 8, H // 8, 4), generator=g).to(device,
                                                                  dtype)
    text = batch["text_embeds"].to(dtype)

    def sample(lat, te, cond, flow):
        with torch.no_grad():
            return pipe.sample(lat, te, torch.zeros_like(te),
                               cond.to(dtype), flow)

    frames, n = counted(lambda: over_data(mesh, sample, latents, text,
                                          batch["cond"], batch["flow"]))
    assert frames.shape == (B, H, H, 3) and bool(torch.isfinite(frames).all())
    out["decode"] = dict(frames=B, checksum=frames.float().abs().sum().item(),
                         launches=n)

    d, dstate = distiller(tiny_models(device), dtype)
    dstate = d.shard_state(mesh, dstate)
    dbatch = {k: v.to(dtype) if k != "flow" else v for k, v in batch.items()}
    (dstate, dm), n = counted(lambda: d.train_step(
        dstate, dbatch, step_generator(0, 1, device)))
    dloss = dm["loss"].item()
    assert np.isfinite(dloss), dloss
    out["distill"] = dict(loss=dloss, launches=n)

    # 15 tiles of a frame larger than the tile, padded to the data axis
    coords = tile_grid(HD_H, HD_W, (TILE, TILE), OVERLAP)
    rng = np.random.default_rng(0)
    cond_t = _crop_batch(rng.integers(0, 256, (1, HD_H, HD_W, 6), np.uint8),
                         coords, TILE, TILE).astype(np.float32) / 255.0
    flow_t = _crop_batch(rng.normal(0, 1, (1, HD_H, HD_W, 4)).astype(
        np.float32), coords, TILE, TILE)
    n_tiles = len(coords)
    pad = (-n_tiles) % mesh.data_size
    if pad:
        cond_t = np.concatenate([cond_t, np.repeat(cond_t[-1:], pad, 0)])
        flow_t = np.concatenate([flow_t, np.repeat(flow_t[-1:], pad, 0)])
    nt = cond_t.shape[0]
    lat_t = torch.randn((nt, TILE // 8, TILE // 8, 4), generator=g).to(
        device, dtype)
    tiles, n = counted(lambda: over_data(
        mesh, sample, lat_t, text[:1].expand(nt, -1, -1),
        torch.from_numpy(cond_t).to(device),
        torch.from_numpy(flow_t).to(device)))
    tiles = tiles.float().cpu().numpy()[:n_tiles]
    merged = merge_tiles([tiles[k][:y2 - y1, :x2 - x1]
                          for k, (y1, y2, x1, x2) in enumerate(coords)],
                         coords, (HD_H, HD_W), feather=OVERLAP,
                         as_uint8=False)
    assert merged.shape == (HD_H, HD_W, 3) and np.isfinite(merged).all()
    out["tiled"] = dict(tiles=n_tiles, pad=pad, launches=n)

    # the sparse mode: CMP-densified flows, chunks split over the data axis
    Hs = 64
    frames_u8 = rng.integers(0, 256, (9, Hs, Hs, 3), np.uint8)
    flows = {t: np.full((Hs, Hs, 2), 1.25, np.float32) for t in range(9)}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        cmp_model = CMP(img_enc_dim=8, sparse_enc_dim=4, nbins=9, fmax=8.0)
    densify = make_cmp_densifier(cmp_model, device)
    lat_s = torch.randn((mesh.data_size, Hs // 8, Hs // 8, 4),
                        generator=g).to(device, dtype)
    text_s = text[:1].expand(mesh.data_size, -1, -1)
    chunks = []

    def sample_fn(cond_c, flow_c):
        chunks.append(cond_c.shape[0])
        return over_data(mesh, sample, lat_s, text_s, cond_c, flow_c)

    with tempfile.TemporaryDirectory() as tdir:
        encode_flows(tdir, gop_schedule(9, 4), flows, flows, "sparse",
                     sparse_bg_ratio=20 / (Hs * Hs))
        enc = EncodedVideo(path=tdir, meta=dict(
            num_frames=9, height=Hs, width=Hs, gop_size=4,
            flow_rate_mode="sparse"))
        dec, n = counted(lambda: decode_inter_frames(
            frames_u8, enc, sample_fn, densify, max_batch=mesh.data_size,
            transfer_dtype=dtype, device=device))
    assert dec.shape == frames_u8.shape and dec.dtype == np.uint8
    out["sparse"] = dict(chunks=len(chunks), chunk=mesh.data_size,
                         launches=n)
    out["mesh"] = mesh.shape
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="",
                   help="also write rank 0's JSON line to this file")
    args = p.parse_args(argv)
    from diffcodec_tpu_torch.config import MeshConfig
    from diffcodec_tpu_torch.parallel.mesh import init_distributed, make_mesh

    _, world = init_distributed(args.device)
    fsdp = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(MeshConfig(fsdp_size=fsdp), args.device)
    result = run(mesh, args.device)
    if dist.get_rank() == 0:
        line = json.dumps({"dryrun": result})
        print(line, flush=True)
        if args.out:
            with open(args.out, "w") as f:
                f.write(line + "\n")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
