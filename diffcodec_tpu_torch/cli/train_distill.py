"""Consistency-distill the DualFlow decoder into a K-step student.

Counterpart: `scripts/train_distill.py` (the same options and defaults,
with `--device`): the frozen teacher (SD-1.5's UNet and a trained
DualFlowControlNet, under CFG at the pinned guidance and conditioning
scales) from `--sd_checkpoint_dir` (a diffusers root: unet/ vae/
text_encoder/ [controlnet/]) and `--controlnet_checkpoint`; the student and
its EMA target warm-started from the teacher; `train/distill.py`'s step
over `UniDataset` batches; `checkpoint-N/state.pt` every
`--checkpointing_steps`, rotated to `--checkpoints_total_limit`, and
`--resume_from_checkpoint latest`.

  python -m diffcodec_tpu_torch.cli.train_distill \\
      --index_file data/index.txt --caption_file data/captions.txt \\
      --sd_checkpoint_dir SD15 --controlnet_checkpoint CN.safetensors \\
      --output_dir runs/distill --max_train_steps 20000

Under torchrun the step runs on the data x fsdp mesh (`parallel/mesh.py`,
one process a device): `--fsdp N` ranks share the masters, the EMA and
the moments, the other axis splits the batch, and rank 0 writes the
checkpoints and the logs (`torchrun --nproc_per_node 8 -m
diffcodec_tpu_torch.cli.train_distill --fsdp 2 ...`).

Decode with the student's EMA weights through `run_codec decode
--distilled_checkpoint runs/distill --student_steps 4`.  The dataset reads
its frames with PIL, so this runs where PIL is; the step runs on
`--device` (default cuda).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    # data
    p.add_argument("--index_file", required=True)
    p.add_argument("--caption_file", default="")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=2)
    p.add_argument("--dataloader_num_workers", type=int, default=4)
    # teacher
    p.add_argument("--sd_checkpoint_dir", default="")
    p.add_argument("--controlnet_checkpoint", default="")
    # distillation
    p.add_argument("--num_teacher_steps", type=int, default=50)
    p.add_argument("--num_student_steps", type=int, default=4)
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--controlnet_conditioning_scale", type=float,
                   default=1.35)
    p.add_argument("--ema_decay", type=float, default=0.995)
    p.add_argument("--distill_loss", choices=["huber", "l2"],
                   default="huber")
    p.add_argument("--no_freeu", action="store_true")
    # optimization
    p.add_argument("--learning_rate", type=float, default=1e-6)
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=100)
    p.add_argument("--max_train_steps", type=int, default=20000)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--seed", type=int, default=0)
    # logging / checkpointing
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default="")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp axis size of the mesh under torchrun: the "
                        "fp32 masters, the EMA and Adam's moments are split "
                        "over this many ranks, the batch over the rest; "
                        "other than 1 needs torchrun --nproc_per_node")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (wiring smoke test)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def step_generator(seed: int, step: int, device) -> "torch.Generator":
    """The step's draws come from a generator seeded by (seed, step), as
    JAX's come from fold_in(PRNGKey(seed), step): a resumed run draws
    what an uninterrupted one would."""
    import torch
    state = np.random.SeedSequence([seed, step]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def build_distiller(args, logger=None):
    """(distiller, state, text_encoder, tokenizer): the teacher's models
    at `--tiny` or SD-1.5 width on `--device`, filled from
    `--sd_checkpoint_dir` / `--controlnet_checkpoint` where given (else
    PyTorch's initialisation from `--seed`), the fused-conv VAE, the
    student and EMA warm-started from the teacher, AdamW with no weight
    decay over the student's fp32 masters."""
    import torch

    from diffcodec_tpu_torch.cli.run_codec import model_configs
    from diffcodec_tpu_torch.config import (DistillConfig, SchedulerConfig,
                                            TrainConfig)
    from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
    from diffcodec_tpu_torch.models.controlnet import DualFlowControlNet
    from diffcodec_tpu_torch.models.unet2d_condition import (
        UNet2DConditionModel)
    from diffcodec_tpu_torch.models.vae import AutoencoderKL
    from diffcodec_tpu_torch.models.weights import (find_weight_file,
                                                    load_sd_checkpoint_dir)
    from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
    from diffcodec_tpu_torch.train.distill import ConsistencyDistiller
    from diffcodec_tpu_torch.train.trainer import Optimizer
    from diffcodec_tpu_torch.utils.tokenizer import default_tokenizer

    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else \
        torch.float32
    unet_cfg, cn_cfg, vae_cfg, clip_cfg = model_configs(args.tiny)
    torch.manual_seed(args.seed)
    with torch.device(args.device):
        unet = UNet2DConditionModel(unet_cfg)
        controlnet = DualFlowControlNet(cn_cfg)
        vae = AutoencoderKL(vae_cfg, fused_conv=True)
        text_encoder = CLIPTextEncoder(clip_cfg)
    if args.sd_checkpoint_dir:
        modules = {"unet": unet, "vae": vae, "text": text_encoder}
        if args.controlnet_checkpoint or find_weight_file(
                os.path.join(args.sd_checkpoint_dir, "controlnet")):
            modules["controlnet"] = controlnet
        loaded = load_sd_checkpoint_dir(
            args.sd_checkpoint_dir, modules,
            controlnet_path=args.controlnet_checkpoint or None)
        if logger is not None:
            for name, rec in loaded.items():
                logger.info("loaded teacher %s from %s", name, rec["path"])

    dcfg = DistillConfig(
        num_teacher_steps=args.num_teacher_steps,
        num_student_steps=args.num_student_steps,
        guidance_scale=args.guidance_scale,
        controlnet_conditioning_scale=args.controlnet_conditioning_scale,
        ema_decay=args.ema_decay, loss=args.distill_loss,
        freeu=not args.no_freeu)
    tcfg = TrainConfig(learning_rate=args.learning_rate,
                       lr_scheduler=args.lr_scheduler,
                       lr_warmup_steps=args.lr_warmup_steps,
                       max_train_steps=args.max_train_steps,
                       max_grad_norm=args.max_grad_norm,
                       adam_weight_decay=0.0, seed=args.seed)
    distiller, state = ConsistencyDistiller.create(
        unet, controlnet, vae, NoiseSchedule.create(SchedulerConfig()), dcfg,
        Optimizer(tcfg), dtype)
    text_encoder = text_encoder.to(dtype).eval().requires_grad_(False)
    return (distiller, state, text_encoder,
            default_tokenizer(clip_cfg.max_length))


def train(args, distiller, state, batches, embed_text, logger):
    """The training loop: resume where `--resume_from_checkpoint` says,
    then one `train_step` a batch of `batches()` (a callable giving an
    epoch of the dataset's numpy batches, 'text_embeds' embedded) until
    `--max_train_steps`, logging and saving checkpoints on the way and at
    the end.  Returns the state."""
    import torch

    from diffcodec_tpu_torch.train.distill import (restore_distill_checkpoint,
                                                   save_distill_checkpoint)
    from diffcodec_tpu_torch.utils.logging import MetricsLogger, StepTimer

    dtype, device = distiller.dtype, args.device
    if args.resume_from_checkpoint:
        step = None if args.resume_from_checkpoint == "latest" else \
            int(args.resume_from_checkpoint)
        restored, start_step = restore_distill_checkpoint(args.output_dir,
                                                          state, step)
        if restored is not None:
            distiller.load_params(state)
            logger.info("resumed from step %d", start_step)
    # the CFG teacher's uncond embedding
    uncond_row = embed_text([""]).to(dtype)
    metrics_logger = MetricsLogger(os.path.join(args.output_dir, "logs"),
                                   logger)
    timer = StepTimer()
    step = state.step
    logger.info("distilling from step %d to %d", step, args.max_train_steps)
    while step < args.max_train_steps:
        seen = 0
        for raw in batches():
            if step >= args.max_train_steps:
                break
            seen += 1
            text = raw["text_embeds"].to(dtype)
            batch = {
                # fp32, as the JAX script's dataset gives it: the noisy
                # samples take the image's dtype
                "image": torch.from_numpy(raw["image"]).to(device),
                "cond": torch.from_numpy(raw["cond"]).to(device, dtype),
                "flow": torch.from_numpy(raw["flow"]).to(device),
                "text_embeds": text,
                "uncond_embeds": uncond_row.expand_as(text)}
            with timer:
                state, metrics = distiller.train_step(
                    state, batch, step_generator(args.seed, step, device))
                loss = metrics["loss"].item()
            step = state.step
            if step % args.log_every == 0:
                metrics_logger.log({"loss": loss,
                                    "t_mean": metrics["t_mean"].item(),
                                    "steps_per_sec": timer.steps_per_sec},
                                   step)
            if args.checkpointing_steps and \
                    step % args.checkpointing_steps == 0:
                save_distill_checkpoint(
                    args.output_dir, state,
                    total_limit=args.checkpoints_total_limit)
                logger.info("saved checkpoint-%d", step)
        if not seen and step < args.max_train_steps:
            raise SystemExit(f"{args.index_file}: fewer samples than one "
                             f"batch of {args.train_batch_size}")
    save_distill_checkpoint(args.output_dir, state,
                            total_limit=args.checkpoints_total_limit)
    logger.info("done at step %d (decode with run_codec decode "
                "--distilled_checkpoint %s)", step, args.output_dir)
    return state


def main(argv=None):
    args = parse_args(argv)
    from diffcodec_tpu_torch.parallel.mesh import is_writer, join_mesh

    mesh = join_mesh(args.fsdp, args.device)
    import logging

    import torch

    from diffcodec_tpu_torch.train.dataset import UniDataset
    from diffcodec_tpu_torch.utils.logging import create_logger

    logger = create_logger("distill")
    if not is_writer():
        logger.setLevel(logging.WARNING)
    distiller, state, text_encoder, tokenizer = build_distiller(args, logger)
    if mesh is not None:
        state = distiller.shard_state(mesh, state)
    dataset = UniDataset(args.caption_file or "/dev/null", args.index_file,
                         resolution=args.resolution, drop_txt_prob=0.0,
                         seed=args.seed)

    @torch.no_grad()
    def embed_text(texts):
        return text_encoder(torch.from_numpy(tokenizer(list(texts))).to(
            args.device))

    B = args.train_batch_size
    if args.dataloader_num_workers > 0:
        from diffcodec_tpu_torch.train.prefetch import PrefetchLoader
        batches = PrefetchLoader(dataset, B,
                                 num_workers=args.dataloader_num_workers,
                                 seed=args.seed,
                                 text_encoder=embed_text).epoch
    else:
        def batches():
            return dataset.iter_batches(B, text_encoder=embed_text)
    train(args, distiller, state, batches, embed_text, logger)


if __name__ == "__main__":
    main()
