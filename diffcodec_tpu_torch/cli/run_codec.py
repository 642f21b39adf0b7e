"""Encode, decode and evaluate a video with the port's codec.

Counterpart: `scripts/run_codec.py` (the same subcommands and options,
and `--device`):

  # frames dir (+ .flo flow dirs) -> bitstream dir
  python -m diffcodec_tpu_torch.cli.run_codec encode --frames FRAMES \\
      --out enc --gop 8 --mode sparse --flow_fwd Flow --flow_bwd Flow_b

  # bitstream dir -> PNG frames; random weights unless --sd_checkpoint_dir
  # (a diffusers SD-1.5 root: unet/ vae/ text_encoder/ [controlnet/]) and
  # --controlnet_checkpoint (a DualFlowControlNet state dict) give them
  python -m diffcodec_tpu_torch.cli.run_codec decode --bitstream enc \\
      --out dec --sd_checkpoint_dir SD15 --controlnet_checkpoint CN.safetensors

  # the same with the K-step student of a `cli.train_distill` run: its EMA
  # weights from the latest checkpoint-N, K evaluations, no CFG
  python -m diffcodec_tpu_torch.cli.run_codec decode --bitstream enc \\
      --out dec --sd_checkpoint_dir SD15 --distilled_checkpoint runs/distill \\
      --student_steps 4

  # decoded against original frames -> PSNR / MS-SSIM, all and inter
  python -m diffcodec_tpu_torch.cli.run_codec eval --orig FRAMES \\
      --pred dec --gop 8

Frames are read and written with PIL and the JPEG anchors go through it,
so the CLI runs where PIL is; what lies below the I/O (the sampler, the
metrics) runs on `--device` (default cuda).  The decode is bf16.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def cmd_encode(args):
    from diffcodec_tpu_torch.codec.gop import gop_schedule
    from diffcodec_tpu_torch.codec.runner import encode_video
    from diffcodec_tpu_torch.config import CodecConfig
    from diffcodec_tpu_torch.eval.codec_eval import load_frames
    from diffcodec_tpu_torch.utils.flo_io import read_flo

    frames = load_frames(args.frames)
    flows_fwd = flows_bwd = None
    if args.mode != "none":
        flows_fwd, flows_bwd = {}, {}
        for item in gop_schedule(frames.shape[0], args.gop):
            t = item.target
            flows_fwd[t] = read_flo(os.path.join(args.flow_fwd,
                                                 f"flow_{t:04d}.flo"))
            flows_bwd[t] = read_flo(os.path.join(args.flow_bwd,
                                                 f"flow_{t:04d}.flo"))
    enc = encode_video(frames, args.out,
                       CodecConfig(gop_size=args.gop,
                                   flow_rate_mode=args.mode),
                       flows_fwd=flows_fwd, flows_bwd=flows_bwd,
                       intra_quality=args.intra_quality)
    print(json.dumps(enc.meta["bpp"], indent=2))


def model_configs(tiny: bool):
    """(UNet, ControlNet, VAE, CLIP text) configs: the CLIs' `--tiny` ones,
    or SD-1.5's."""
    from diffcodec_tpu_torch.config import (CLIPTextConfig, ControlNetConfig,
                                            UNetConfig, VAEConfig)
    if tiny:
        return (UNetConfig.tiny(), ControlNetConfig.tiny(),
                VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                          layers_per_block=1), CLIPTextConfig.tiny())
    unet_cfg = UNetConfig()
    return (unet_cfg, ControlNetConfig(unet=unet_cfg), VAEConfig(),
            CLIPTextConfig())


def build_pipeline(tiny: bool, sampler, device, sd_dir: str = "",
                   controlnet_path: str = "", text_encoder: bool = False):
    """(pipe, clip): the DualFlow pipeline on `device` in bf16 (`tiny`
    configs or SD-1.5's) sampling with the `SamplerConfig` `sampler`, its
    weights from the diffusers root `sd_dir` and the ControlNet state dict
    `controlnet_path` where given (else PyTorch's initialisation from seed
    0); with `text_encoder` and a root, the root's CLIP text encoder as
    `clip`, else None."""
    from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline

    dtype = torch.bfloat16
    unet_cfg, cn_cfg, vae_cfg, clip_cfg = model_configs(tiny)
    torch.manual_seed(0)
    pipe = DualFlowPipeline.create(unet_cfg, cn_cfg, vae_cfg, sampler,
                                   dtype=dtype, device=device)
    if not sd_dir:
        return pipe, None
    from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
    from diffcodec_tpu_torch.models.weights import load_sd_checkpoint_dir

    modules = {"unet": pipe.unet, "controlnet": pipe.controlnet,
               "vae": pipe.vae}
    clip = None
    if text_encoder:
        with torch.device(device):
            clip = modules["text"] = CLIPTextEncoder(clip_cfg).to(
                dtype).eval()
    load_sd_checkpoint_dir(sd_dir, modules,
                           controlnet_path=controlnet_path or None)
    return pipe, clip


def load_decoder(args, device):
    """(pipe, text, uncond) for the decode options: the exact CFG pipeline
    with the prompt's and the negative prompt's embeddings [1, L, D]
    through the root's CLIP text encoder (zeros without a root, as the JAX
    CLI); or, with `--distilled_checkpoint`, a `DistilledPipeline` (K =
    `--student_steps`, no CFG: uncond None) whose UNet and ControlNet hold
    the EMA weights of the run's latest checkpoint-N
    (`train.distill.load_student`)."""
    from diffcodec_tpu_torch.config import DistillConfig, SamplerConfig
    from diffcodec_tpu_torch.sampling.distilled import DistilledPipeline
    from diffcodec_tpu_torch.train.checkpoint import restore_checkpoint
    from diffcodec_tpu_torch.train.distill import load_student
    from diffcodec_tpu_torch.utils.tokenizer import default_tokenizer

    pipe, clip = build_pipeline(
        args.tiny, SamplerConfig(
            num_inference_steps=args.steps, guidance_scale=args.guidance,
            controlnet_conditioning_scale=args.cond_scale,
            controlnet_interval=args.cn_interval,
            unet_encoder_interval=args.enc_interval),
        device, args.sd_checkpoint_dir, args.controlnet_checkpoint,
        text_encoder=True)
    if clip is None:
        text = uncond = torch.zeros(
            (1, 77, pipe.unet.cfg.cross_attention_dim),
            dtype=torch.bfloat16, device=device)
    else:
        text, uncond = pipe.encode_prompt(
            clip, default_tokenizer(clip.cfg.max_length), [args.prompt],
            [args.negative_prompt])
    if not args.distilled_checkpoint:
        return pipe, text, uncond
    saved, step = restore_checkpoint(args.distilled_checkpoint)
    if saved is None:
        raise SystemExit(
            f"no checkpoint-N dir under {args.distilled_checkpoint}")
    load_student(pipe.unet, pipe.controlnet, saved["ema_params"])
    print(f"distilled student from step {step} "
          f"({args.student_steps}-step decode)")
    dpipe = DistilledPipeline.from_pipeline(pipe, DistillConfig(
        num_student_steps=args.student_steps, guidance_scale=args.guidance,
        controlnet_conditioning_scale=args.cond_scale))
    return dpipe, text, None


def make_sampler(pipe, text, uncond, seed: int, device):
    """`decode_video`'s sample_fn: the same seeded latent noise each call
    (as the JAX CLI's fixed key), then CFG over the prompt embeddings; or,
    where `uncond` is None, `pipe` is a `DistilledPipeline` (no CFG batch)
    whose re-noises follow the latents from the same generator."""
    gen = torch.Generator(device=device)

    def sample_fn(cond, flow):
        B, H, W = cond.shape[:3]
        gen.manual_seed(seed)
        latents = torch.randn((B, H // 8, W // 8, 4), generator=gen,
                              device=device)
        if uncond is None:
            return pipe.sample(latents, text.expand(B, -1, -1), cond, flow,
                               generator=gen)
        return pipe.sample(latents, text.expand(B, -1, -1),
                           uncond.expand(B, -1, -1), cond, flow)

    return sample_fn


def build_sampler(args, device):
    """`decode_video`'s sample_fn for the decode options (`load_decoder`)."""
    return make_sampler(*load_decoder(args, device), args.seed, device)


def cmd_decode(args):
    from PIL import Image

    from diffcodec_tpu_torch.codec.runner import EncodedVideo, decode_video

    enc = EncodedVideo.load(args.bitstream)
    out = decode_video(enc, build_sampler(args, args.device),
                       max_batch=args.max_batch,
                       transfer_dtype=torch.bfloat16, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    for i, frame in enumerate(out):
        Image.fromarray(frame).save(os.path.join(args.out,
                                                 f"frame_{i:04d}.png"))
    print(f"decoded {len(out)} frames -> {args.out}")


def cmd_eval(args):
    from diffcodec_tpu_torch.eval.codec_eval import evaluate_video
    print(json.dumps(evaluate_video(args.orig, args.pred, args.gop,
                                    args.device), indent=2))


def add_decode_options(p: argparse.ArgumentParser) -> None:
    """The sampler and checkpoint options `decode` and `rd_sweep` share."""
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--guidance", type=float, default=3.5)
    p.add_argument("--cond_scale", type=float, default=1.35)
    p.add_argument("--cn_interval", type=int, default=1,
                   help="reuse the ControlNet residuals for k-1 steps "
                        "(an opt-in approximation; 1 = exact)")
    p.add_argument("--enc_interval", type=int, default=1,
                   help="reuse the UNet down path for k-1 steps (an "
                        "opt-in approximation; 1 = exact)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny models (smoke testing)")
    p.add_argument("--sd_checkpoint_dir", default="",
                   help="diffusers-layout SD-1.5 root (unet/ vae/ "
                        "text_encoder/ [controlnet/]) of torch weights")
    p.add_argument("--controlnet_checkpoint", default="",
                   help="DualFlowControlNet torch state dict "
                        "(.safetensors / .bin), overriding controlnet/")
    p.add_argument("--prompt", default="")
    p.add_argument("--negative_prompt", default="")
    p.add_argument("--distilled_checkpoint", default="",
                   help="output dir of a cli.train_distill run: decode "
                        "with the consistency student's EMA weights in "
                        "--student_steps evaluations, no CFG "
                        "(sampling/distilled.py)")
    p.add_argument("--student_steps", type=int, default=4,
                   help="K for the distilled decode")
    p.add_argument("--device", default="cuda")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode")
    pe.add_argument("--frames", required=True)
    pe.add_argument("--out", required=True)
    pe.add_argument("--gop", type=int, default=8)
    pe.add_argument("--mode", choices=["none", "sparse", "dense"],
                    default="sparse")
    pe.add_argument("--flow_fwd", default="")
    pe.add_argument("--flow_bwd", default="")
    pe.add_argument("--intra_quality", type=int, default=30)

    pd = sub.add_parser("decode")
    pd.add_argument("--bitstream", required=True)
    pd.add_argument("--out", required=True)
    pd.add_argument("--max_batch", type=int, default=7,
                    help="inter frames per sampler call")
    add_decode_options(pd)

    pv = sub.add_parser("eval")
    pv.add_argument("--orig", required=True)
    pv.add_argument("--pred", required=True)
    pv.add_argument("--gop", type=int, default=8)
    pv.add_argument("--device", default="cuda")

    args = p.parse_args(argv)
    {"encode": cmd_encode, "decode": cmd_decode, "eval": cmd_eval}[args.cmd](
        args)


if __name__ == "__main__":
    main()
