"""Train the standalone residual pixel DDPM.

Counterpart: `scripts/train_residual.py` (the same options and defaults,
with `--device`): `UNet2DModel` (64, 128, 128, 256), fp32, on the warp
residuals of `UniDataset` batches (`train.residue.make_residue_batch`),
the 500-step squaredcos_cap_v2 DDPM, AdamW 4e-4, 30 epochs, one
`ddpm_train_step` a batch; `checkpoint-N/state.pt` with the UNet's
parameters every `--checkpointing_steps` and at the end.

  python -m diffcodec_tpu_torch.cli.train_residual \\
      --index_file data/index.txt --output_dir runs/residual

The dataset reads its frames with PIL, so this runs where PIL is; the
step runs on `--device` (default cuda).
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--index_file", required=True)
    p.add_argument("--caption_file", default="/dev/null")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--train_batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=4e-4)
    p.add_argument("--num_epochs", type=int, default=30)
    p.add_argument("--num_train_timesteps", type=int, default=500)
    p.add_argument("--checkpointing_steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from diffcodec_tpu_torch.cli.train_distill import step_generator
    from diffcodec_tpu_torch.config import SchedulerConfig, TrainConfig
    from diffcodec_tpu_torch.models.unet2d import UNet2DModel
    from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
    from diffcodec_tpu_torch.train.checkpoint import save_checkpoint
    from diffcodec_tpu_torch.train.dataset import UniDataset
    from diffcodec_tpu_torch.train.residue import (ddpm_train_step,
                                                   make_residue_batch)
    from diffcodec_tpu_torch.train.trainer import Optimizer
    from diffcodec_tpu_torch.utils.logging import (MetricsLogger,
                                                   create_logger)

    logger = create_logger("residual_train")
    device = args.device
    schedule = NoiseSchedule.create(SchedulerConfig(
        num_train_timesteps=args.num_train_timesteps,
        beta_schedule="squaredcos_cap_v2", beta_start=0.0001,
        beta_end=0.02))
    torch.manual_seed(args.seed)
    with torch.device(device):
        unet = UNet2DModel()
    # optax.adamw(lr) with optax's defaults, unclipped
    tx = Optimizer(TrainConfig(learning_rate=args.learning_rate,
                               adam_weight_decay=1e-4,
                               max_grad_norm=float("inf")))
    opt_state = tx.init(dict(unet.named_parameters()))

    def params():
        return {"params": {n: p.detach()
                           for n, p in unet.named_parameters()}}

    dataset = UniDataset(args.caption_file, args.index_file,
                         resolution=args.resolution, seed=args.seed)
    mlog = MetricsLogger(logger=logger)
    step = 0
    for epoch in range(args.num_epochs):
        for batch in dataset.iter_batches(args.train_batch_size):
            batch.pop("text")
            rb = make_residue_batch({k: torch.from_numpy(v).to(device)
                                     for k, v in batch.items()})
            loss = ddpm_train_step(unet, schedule, tx, opt_state,
                                   rb["residual"],
                                   step_generator(args.seed, step, device))
            step += 1
            if step % 10 == 0:
                mlog.log({"loss": loss.item(), "epoch": epoch}, step)
            if step % args.checkpointing_steps == 0:
                save_checkpoint(args.output_dir, step, params())
    save_checkpoint(args.output_dir, step, params())
    logger.info("done: %d steps", step)


if __name__ == "__main__":
    main()
