"""Train the CMP from a reference-format experiment config.

Counterpart: `scripts/train_cmp.py` (the same options, with `--device`):
one config file (YAML in the reference's schema, or the same dict as JSON,
`train/cmp_config.py`) sets the model, the SGD schedule, the sparse
sampling and the cadence.  The model is initialised from `--seed`; each
step's dropout masks (the AlexNet backbones) come from a generator seeded
by (seed, step).

Data: `--synthetic N` trains on N generated (image, dense flow) pairs,
the same numpy draws as the JAX script's; `--data_npz` reads a .npz with
`images` [N, H, W, 3] uint8 and `flows` [N, H, W, 2] float32.  Sparse
guidance comes from `codec.sparse_flow.flow_sampler` with the config's
`sample_strategy`, `sample_bg_ratio`, `nms_ks` and `max_num_guide`, from
the same generator and in the same order as the JAX script's, and the
batches follow the reference's seed-0 sampler; so both scripts train on
bit-identical batches.

Checkpoints: `checkpoint-{iter}/state.pt` (parameters, BatchNorm
statistics, momentum, `train/checkpoint.py`) every `save_freq` and at the
end; `--resume latest` (or a step) continues the counter and the sampler.

  python -m diffcodec_tpu_torch.cli.train_cmp --config config.yaml \\
      --output_dir runs/cmp --synthetic 64 --crop 384
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="reference-format CMP experiment YAML (or JSON)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N generated samples (smoke/drill mode)")
    p.add_argument("--data_npz", default=None,
                   help=".npz with images [N,H,W,3] u8, flows [N,H,W,2] f32")
    p.add_argument("--total_iter", type=int, default=None,
                   help="override the config's model.total_iter")
    p.add_argument("--crop", type=int, default=None,
                   help="override the config's data.crop_size (square)")
    p.add_argument("--resume", default=None,
                   help="'latest' or a checkpoint step to resume from")
    p.add_argument("--save_freq", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _synthetic_bank(n, crop, rng):
    imgs = rng.uniform(-1, 1, (n, crop, crop, 3)).astype(np.float32)
    # smooth dense flows: random affine field per sample
    yy, xx = np.meshgrid(np.linspace(-1, 1, crop), np.linspace(-1, 1, crop),
                         indexing="ij")
    flows = np.empty((n, crop, crop, 2), np.float32)
    for i in range(n):
        a = rng.uniform(-3, 3, (2, 3))
        flows[i, ..., 0] = a[0, 0] * xx + a[0, 1] * yy + a[0, 2]
        flows[i, ..., 1] = a[1, 0] * xx + a[1, 1] * yy + a[1, 2]
    return imgs, flows


def _load_npz(path, crop):
    data = np.load(path)
    imgs = data["images"].astype(np.float32) / 127.5 - 1.0
    flows = data["flows"].astype(np.float32)
    assert imgs.shape[1] >= crop and imgs.shape[2] >= crop, imgs.shape
    return imgs[:, :crop, :crop], flows[:, :crop, :crop]


def make_batch(imgs, flows, idx, sample_sparse) -> dict:
    """The step's numpy batch: the images and target flows at `idx`, and
    each sample's sparse guidance (flow and mask, 4 channels) in order."""
    return {"image": imgs[idx],
            "sparse": np.stack([sample_sparse(flows[i]) for i in idx]),
            "flow_target": flows[idx]}


def build(cfg, seed: int, device):
    """The CMPTrainer for a parsed config: the model initialised on the CPU
    under `torch.manual_seed(seed)` (the global generator's state restored
    after), then moved to `device`, and the config's SGD."""
    import torch

    from diffcodec_tpu_torch.train.cmp_config import (build_cmp_model,
                                                      build_cmp_optimizer)
    from diffcodec_tpu_torch.train.cmp_train import CMPTrainer

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_cmp_model(cfg)
    return CMPTrainer(model=model.to(device), tx=build_cmp_optimizer(cfg),
                      nbins=cfg.module.nbins, fmax=float(cfg.module.fmax))


def main(argv=None):
    args = parse_args(argv)
    import torch

    from diffcodec_tpu_torch.cli.train_distill import step_generator
    from diffcodec_tpu_torch.codec.sparse_flow import flow_sampler
    from diffcodec_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      save_checkpoint)
    from diffcodec_tpu_torch.train.cmp_config import load_cmp_config
    from diffcodec_tpu_torch.train.cmp_train import (
        distributed_given_iteration_indices)

    cfg = load_cmp_config(args.config)
    total_iter = args.total_iter or cfg.schedule.total_iter
    crop = args.crop or cfg.data.crop_size[0]
    save_freq = args.save_freq or cfg.trainer.save_freq
    batch = cfg.data.batch_size
    rng = np.random.default_rng(args.seed)

    if args.synthetic:
        imgs, flows = _synthetic_bank(args.synthetic, crop, rng)
    elif args.data_npz:
        imgs, flows = _load_npz(args.data_npz, crop)
    else:
        raise SystemExit("need --synthetic N or --data_npz (the config's "
                         "train_source lists are torch-dataset paths; "
                         "convert offline)")

    def sample_sparse(flow):
        sparse, mask = flow_sampler(
            flow, strategy=tuple(cfg.data.sample_strategy),
            bg_ratio=cfg.data.sample_bg_ratio, nms_ks=cfg.data.nms_ks,
            max_num_guide=cfg.data.max_num_guide, rng=rng)
        return np.concatenate(
            [sparse, mask[..., :2].astype(np.float32)], axis=-1)

    trainer = build(cfg, args.seed, args.device)
    start_iter = 0
    if args.resume:
        want = None if args.resume == "latest" else int(args.resume)
        saved, step = restore_checkpoint(args.output_dir, want)
        if saved is not None:
            trainer.load_state_dict(saved)
            start_iter = step
            print(f"resumed from checkpoint-{step}")

    # the reference's seed-0 global shuffle, resumed after the last step
    order = distributed_given_iteration_indices(
        len(imgs), total_iter, batch, world_size=1, rank=0,
        last_iter=start_iter - 1)

    t0 = time.time()
    for it in range(start_iter, total_iter):
        idx = order[(it - start_iter) * batch:(it - start_iter + 1) * batch]
        b = {k: torch.from_numpy(v).to(args.device)
             for k, v in make_batch(imgs, flows, idx, sample_sparse).items()}
        loss = trainer.train_step(b, step_generator(args.seed, it,
                                                    args.device))
        if (it + 1) % cfg.trainer.print_freq == 0 or it + 1 == total_iter:
            print(f"iter {it + 1}/{total_iter} loss_flow={float(loss):.4f} "
                  f"({(time.time() - t0) / (it - start_iter + 1):.2f} s/it)")
        if (it + 1) % save_freq == 0 or it + 1 == total_iter:
            path = save_checkpoint(args.output_dir, it + 1,
                                   trainer.state_dict())
            print("saved", path)
    print("done")


if __name__ == "__main__":
    main()
