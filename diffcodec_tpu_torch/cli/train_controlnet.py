"""Train the DualFlowControlNet (or ResControlNet).

Counterpart: `scripts/train_controlnet.py` (the same options and defaults,
with `--device`; the reference's `train_controlnet.py:320-680` /
`train_rescontrolnet.py`): the frozen SD-1.5 UNet, the fused-conv VAE and
the CLIP text encoder at `--tiny` or SD-1.5 width, filled from the flat
`--sd_checkpoint_dir` layout `{vae,unet,text}{.safetensors,.bin}` where
given (else PyTorch's initialisation from `--seed`); the ControlNet
warm-started from `--pretrained_checkpoint` (reference tensor names,
shape-filtered); `train/trainer.py`'s step over `UniDataset` batches, its
draws from `step_generator(seed, step)`; `checkpoint-N/state.pt` every
`--checkpointing_steps`, rotated to `--checkpoints_total_limit`, and
`--resume_from_checkpoint latest`; in-training validation panels every
`--validation_steps` (`train/validation.py`).

  python -m diffcodec_tpu_torch.cli.train_controlnet \\
      --index_file data/index.txt --caption_file data/captions.txt \\
      --output_dir runs/dualflow --resolution 512 \\
      --train_batch_size 8 --learning_rate 1e-5 --max_train_steps 100000 \\
      --perceptual_weight 0.01 --edge_weight 0.05 \\
      --checkpointing_steps 500 --checkpoints_total_limit 5 \\
      --resume_from_checkpoint latest

Export the ControlNet to the reference's names with `cli.export_checkpoint`.
The dataset reads its frames with PIL, so this runs where PIL is; the step
runs on `--device` (default cuda).
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
    p.add_argument("--report_to", default="tensorboard",
                   choices=["tensorboard", "wandb", "all"],
                   help="scalar sinks (train_controlnet.py:519-523): the "
                        "port writes stdout lines, and wandb with wandb or "
                        "all where the package imports; no TensorBoard "
                        "file")
    p.add_argument("--tracker_project_name", default="diffcodec_tpu",
                   help="wandb project (reference --tracker_project_name)")
    p.add_argument("--caption_file", default="")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--train_batch_size", type=int, default=4)
    p.add_argument("--dataloader_drop_text_prob", type=float, default=0.3)
    p.add_argument("--dataloader_num_workers", type=int, default=4,
                   help="prefetch worker threads (0 = synchronous), the "
                        "reference's DataLoader num_workers role")
    # model
    p.add_argument("--model_variant", choices=["dualflow", "res"],
                   default="dualflow")
    p.add_argument("--pretrained_checkpoint", default="",
                   help="torch state dict (safetensors/.bin) to warm-start "
                        "the controlnet from (shape-filtered)")
    p.add_argument("--sd_checkpoint_dir", default="",
                   help="dir with SD-1.5 torch state dicts (vae/unet/text)")
    # optimization (train_controlnet.py flag names)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "linear",
                            "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--max_train_steps", type=int, default=100000)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute the ControlNet+UNet forwards in backward "
                        "(reference train_controlnet.py:421)")
    p.add_argument("--lowp_adam", action="store_true",
                   help="bf16 Adam moments, the --use_8bit_adam analogue "
                        "(reference train_controlnet.py:469)")
    p.add_argument("--adam_update_chunks", type=int, default=0,
                   help="accepted for the JAX script's command lines; the "
                        "port's update runs tensor by tensor already "
                        "(TrainConfig.adam_update_chunks)")
    p.add_argument("--long_attn_impl", default="",
                   choices=["", "einsum", "qchunk", "flash", "chunked"],
                   help="'' and 'flash' only: every attention call of the "
                        "port runs its flash kernel on the card "
                        "(csrc/attention.cu), which keeps no logits for "
                        "the backward; the JAX package's other "
                        "implementations have no counterpart")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--perceptual_weight", type=float, default=0.0)
    p.add_argument("--lpips_checkpoint", default="",
                   help="torch lpips-alex state dict for the perceptual "
                        "loss (random init if absent)")
    p.add_argument("--edge_weight", type=float, default=0.0)
    p.add_argument("--mixed_precision", default="bf16",
                   choices=["no", "bf16"])
    p.add_argument("--seed", type=int, default=0)
    # checkpointing
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default="",
                   help="'latest' or a step number")
    # validation
    p.add_argument("--validation_steps", type=int, default=0)
    p.add_argument("--validation_index_file", default="")
    # parallelism
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp axis size; other than 1 needs the mesh, "
                        "which the port does not have yet")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--latent_cache_dir", default="",
                   help="precompute frozen-VAE latent moments here (once) "
                        "and skip the encoder in every train step: the "
                        "same math given the same draws "
                        "(train/latent_cache.py).  Disables ColorJitter "
                        "(cached pixels must be the pixels trained on); "
                        "dualflow variant only.")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model configs (harness smoke tests)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _load_flat(module, name: str, sd_dir: str, logger):
    """Fill `module` from `{sd_dir}/{name}.safetensors` or `.bin`, the
    first that exists (`train_controlnet.py`'s flat layout), non-strict."""
    from diffcodec_tpu_torch.models.weights import (load_state_dict_into,
                                                    load_torch_state_dict,
                                                    module_names)
    for ext in (".safetensors", ".bin"):
        path = os.path.join(sd_dir, name + ext)
        if os.path.exists(path):
            load_state_dict_into(module, load_torch_state_dict(path),
                                 module_names(name, module), strict=False)
            if logger is not None:
                logger.info("loaded %s from %s", name, path)
            return


def build_trainer(args, logger=None):
    """(trainer, state, text_encoder, tokenizer): the models at `--tiny`
    or SD-1.5 width on `--device` (the fused-conv VAE; the LPIPS network
    where `--perceptual_weight` is set, from `--lpips_checkpoint` where it
    exists), filled from `--sd_checkpoint_dir` and warm-started from
    `--pretrained_checkpoint` where given; the trainer over the compute
    dtype's working copies, and its state: the ControlNet's fp32 masters
    and AdamW's moments, restored from `--resume_from_checkpoint` where a
    checkpoint is found."""
    import torch

    from diffcodec_tpu_torch.cli.run_codec import model_configs
    from diffcodec_tpu_torch.config import SchedulerConfig, TrainConfig
    from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
    from diffcodec_tpu_torch.models.controlnet import (DualFlowControlNet,
                                                       ResControlNet)
    from diffcodec_tpu_torch.models.unet2d_condition import (
        UNet2DConditionModel)
    from diffcodec_tpu_torch.models.vae import AutoencoderKL
    from diffcodec_tpu_torch.models.weights import load_torch_state_dict
    from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule
    from diffcodec_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                      warm_start_filter)
    from diffcodec_tpu_torch.train.trainer import (ControlNetTrainer,
                                                   Optimizer, TrainState)
    from diffcodec_tpu_torch.utils.tokenizer import default_tokenizer

    if args.long_attn_impl not in ("", "flash"):
        raise SystemExit(
            f"--long_attn_impl {args.long_attn_impl}: the port's attention "
            "is its flash kernel on the card (csrc/attention.cu); only '' "
            "and 'flash' are accepted")
    dtype = torch.bfloat16 if args.mixed_precision == "bf16" else \
        torch.float32
    unet_cfg, cn_cfg, vae_cfg, clip_cfg = model_configs(args.tiny)
    torch.manual_seed(args.seed)
    controlnet_cls = (DualFlowControlNet if args.model_variant == "dualflow"
                      else ResControlNet)
    with torch.device(args.device):
        unet = UNet2DConditionModel(unet_cfg)
        controlnet = controlnet_cls(cn_cfg)
        vae = AutoencoderKL(vae_cfg, fused_conv=True)
        text_encoder = CLIPTextEncoder(clip_cfg)
    lpips = None
    if args.perceptual_weight:
        from diffcodec_tpu_torch.models.weights import (load_state_dict_into,
                                                        module_names)
        from diffcodec_tpu_torch.train.lpips import LPIPS
        with torch.device(args.device):
            lpips = LPIPS().eval()
        if args.lpips_checkpoint and os.path.exists(args.lpips_checkpoint):
            load_state_dict_into(lpips,
                                 load_torch_state_dict(args.lpips_checkpoint),
                                 module_names("lpips", lpips), strict=False)
            if logger is not None:
                logger.info("loaded LPIPS weights from %s",
                            args.lpips_checkpoint)
    if args.sd_checkpoint_dir:
        for name, module in (("vae", vae), ("unet", unet),
                             ("text", text_encoder)):
            _load_flat(module, name, args.sd_checkpoint_dir, logger)

    params = dict(controlnet.named_parameters())
    if args.pretrained_checkpoint and os.path.exists(
            args.pretrained_checkpoint):
        params, copied = warm_start_filter(
            params, load_torch_state_dict(args.pretrained_checkpoint))
        params = {n: t.to(args.device) for n, t in params.items()}
        if logger is not None:
            logger.info("warm-started %d tensors", copied)

    tcfg = TrainConfig(
        learning_rate=args.learning_rate, lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, adam_weight_decay=args.adam_weight_decay,
        adam_epsilon=args.adam_epsilon, max_grad_norm=args.max_grad_norm,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lpips_weight=args.perceptual_weight, edge_weight=args.edge_weight,
        checkpointing_steps=args.checkpointing_steps,
        checkpoints_total_limit=args.checkpoints_total_limit,
        seed=args.seed, remat=args.gradient_checkpointing,
        lowp_adam_moments=args.lowp_adam,
        adam_update_chunks=args.adam_update_chunks)
    state = TrainState.create(params, Optimizer(tcfg))
    trainer = ControlNetTrainer(
        unet=unet.to(dtype).eval(), controlnet=controlnet.to(dtype),
        vae=vae.to(dtype).eval(),
        schedule=NoiseSchedule.create(SchedulerConfig()), config=tcfg,
        lpips=lpips)
    if args.resume_from_checkpoint:
        step = None if args.resume_from_checkpoint == "latest" else \
            int(args.resume_from_checkpoint)
        saved, step = restore_checkpoint(args.output_dir, step)
        if saved is not None:
            state.load_state_dict(saved)
            if logger is not None:
                logger.info("resumed from step %d", step)
    trainer.load_params(state.params)
    text_encoder = text_encoder.to(dtype).eval().requires_grad_(False)
    return (trainer, state, text_encoder,
            default_tokenizer(clip_cfg.max_length))


def device_batch(raw, dtype, device, variant: str = "dualflow"):
    """A dataset batch (numpy arrays, 'text_embeds' a tensor) on `device`:
    the pixels, flows and cached moments fp32, as the JAX script hands
    them to its step, the text embeddings in `dtype`; for the `res`
    variant, the residue batch (`make_residue_batch`) made there."""
    import torch

    batch = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
             for k, v in raw.items() if k not in ("text", "text_embeds")}
    batch["text_embeds"] = raw["text_embeds"].to(device, dtype)
    if variant == "res":
        from diffcodec_tpu_torch.train.residue import make_residue_batch
        batch = make_residue_batch(batch)
    return batch


def train(args, trainer, state, batches, embed_text, logger, validate=None):
    """The training loop: one `train_step` a batch of `batches()` (a
    callable giving an epoch of the dataset's numpy batches, 'text_embeds'
    embedded), from the state's step to `--max_train_steps`, each step's
    draws from `step_generator(--seed, step)`; the metrics every
    `--log_every` steps, a checkpoint every `--checkpointing_steps` and at
    the end, `validate(state, step, metrics_logger)` every
    `--validation_steps` where given.  `embed_text` is
    `train_distill.train`'s argument; the batches carry their embeddings
    here.  Returns the state."""
    from diffcodec_tpu_torch.cli.train_distill import step_generator
    from diffcodec_tpu_torch.train.checkpoint import save_checkpoint
    from diffcodec_tpu_torch.utils.logging import MetricsLogger, StepTimer

    dtype = next(trainer.controlnet.parameters()).dtype
    metrics_logger = MetricsLogger(
        os.path.join(args.output_dir, "logs"), logger,
        wandb_project=(args.tracker_project_name
                       if args.report_to in ("wandb", "all") else None))
    timer = StepTimer()
    step = state.step
    logger.info("training from step %d to %d", step, args.max_train_steps)
    while step < args.max_train_steps:
        seen = 0
        for raw in batches():
            if step >= args.max_train_steps:
                break
            seen += 1
            batch = device_batch(raw, dtype, args.device, args.model_variant)
            with timer:
                state, metrics = trainer.train_step(
                    state, batch, step_generator(args.seed, step,
                                                 args.device))
                metrics = {k: v.item() for k, v in metrics.items()}
            step = state.step
            if step % args.log_every == 0:
                metrics["steps_per_sec"] = timer.steps_per_sec
                metrics_logger.log(metrics, step)
            if args.checkpointing_steps and \
                    step % args.checkpointing_steps == 0:
                save_checkpoint(args.output_dir, step, state.state_dict(),
                                total_limit=args.checkpoints_total_limit)
                logger.info("saved checkpoint-%d", step)
            if validate is not None and args.validation_steps and \
                    step % args.validation_steps == 0:
                validate(state, step, metrics_logger)
        if not seen and step < args.max_train_steps:
            raise SystemExit(f"{args.index_file}: fewer samples than one "
                             f"batch of {args.train_batch_size}")
    save_checkpoint(args.output_dir, step, state.state_dict(),
                    total_limit=args.checkpoints_total_limit)
    logger.info("done at step %d", step)
    return state


def make_validator(args, trainer, val_batch):
    """`validate(state, step, metrics_logger)` for `train`: a 20-step, CFG 3.5
    `DualFlowPipeline` over the trainer's models (the ControlNet's working
    copy holds the masters) on `val_batch` (numpy, 'text_embeds' a
    tensor), zero uncond embeddings and the same initial latents each
    time, drawn from a generator seeded by `--seed`; panels under
    `{output_dir}/validation`.  The pipeline is `validate.pipeline`."""
    import torch

    from diffcodec_tpu_torch.config import SamplerConfig
    from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
    from diffcodec_tpu_torch.train.validation import run_validation

    pipe = DualFlowPipeline(
        unet=trainer.unet, controlnet=trainer.controlnet, vae=trainer.vae,
        schedule=trainer.schedule,
        sampler=SamplerConfig(num_inference_steps=20, guidance_scale=3.5))
    B, H, W = val_batch["cond"].shape[:3]
    latents = torch.randn(
        (B, H // 8, W // 8, 4), device=args.device,
        generator=torch.Generator(device=args.device).manual_seed(args.seed))
    text = val_batch["text_embeds"]
    out_dir = os.path.join(args.output_dir, "validation")

    def validate(state, step, metrics_logger):
        return run_validation(
            pipe, {k: val_batch[k] for k in ("cond", "flow", "image")},
            text, torch.zeros_like(text), latents, out_dir=out_dir,
            logger=metrics_logger, step=step)

    validate.pipeline = pipe
    return validate


def main(argv=None):
    args = parse_args(argv)
    if args.fsdp != 1:
        raise SystemExit(
            "--fsdp other than 1 needs the mesh (parallel/mesh.py on "
            "torch.distributed, ROADMAP.md queue A), which the port does "
            "not have yet")
    if args.latent_cache_dir and args.model_variant == "res":
        raise SystemExit(
            "--latent_cache_dir is dualflow-only: the res variant's "
            "encode target (the residual) is built in-loop, after the "
            "cacheable dataset stage")
    import torch

    from diffcodec_tpu_torch.train.dataset import UniDataset
    from diffcodec_tpu_torch.utils.logging import create_logger

    logger = create_logger("train")
    trainer, state, text_encoder, tokenizer = build_trainer(args, logger)
    B = args.train_batch_size
    dataset = UniDataset(args.caption_file or "/dev/null", args.index_file,
                         resolution=args.resolution,
                         drop_txt_prob=args.dataloader_drop_text_prob,
                         transform=not args.latent_cache_dir,
                         seed=args.seed)
    if args.latent_cache_dir:
        from diffcodec_tpu_torch.train.latent_cache import (
            LatentCachedDataset, cache_complete, precompute_latent_moments)
        if not cache_complete(args.latent_cache_dir, len(dataset)):
            logger.info("precomputing latent moments -> %s",
                        args.latent_cache_dir)
            n = precompute_latent_moments(trainer.vae, dataset,
                                          args.latent_cache_dir,
                                          batch_size=B)
            logger.info("cached %d samples", n)
        dataset = LatentCachedDataset(dataset, args.latent_cache_dir)

    @torch.no_grad()
    def embed_text(texts):
        return text_encoder(torch.from_numpy(tokenizer(list(texts))).to(
            args.device))

    validate = None
    if args.validation_steps and args.validation_index_file:
        val_ds = UniDataset(args.caption_file or "/dev/null",
                            args.validation_index_file,
                            resolution=args.resolution, drop_txt_prob=0.0,
                            transform=False, seed=args.seed)
        val_batch = next(val_ds.iter_batches(min(B, len(val_ds)),
                                             text_encoder=embed_text,
                                             shuffle=False))
        validate = make_validator(args, trainer, val_batch)
    if args.dataloader_num_workers > 0:
        from diffcodec_tpu_torch.train.prefetch import PrefetchLoader
        batches = PrefetchLoader(dataset, B,
                                 num_workers=args.dataloader_num_workers,
                                 seed=args.seed,
                                 text_encoder=embed_text).epoch
    else:
        def batches():
            return dataset.iter_batches(B, text_encoder=embed_text)
    train(args, trainer, state, batches, embed_text, logger, validate)


if __name__ == "__main__":
    main()
