"""Encode, decode and evaluate a video with the port's codec.

Counterpart: `scripts/run_codec.py` (the same subcommands and options,
and `--device`; the distilled student's `--distilled_checkpoint` waits
for the distillation trainer):

  # frames dir (+ .flo flow dirs) -> bitstream dir
  python -m diffcodec_tpu_torch.cli.run_codec encode --frames FRAMES \\
      --out enc --gop 8 --mode sparse --flow_fwd Flow --flow_bwd Flow_b

  # bitstream dir -> PNG frames; random weights unless --sd_checkpoint_dir
  # (a diffusers SD-1.5 root: unet/ vae/ text_encoder/ [controlnet/]) and
  # --controlnet_checkpoint (a DualFlowControlNet state dict) give them
  python -m diffcodec_tpu_torch.cli.run_codec decode --bitstream enc \\
      --out dec --sd_checkpoint_dir SD15 --controlnet_checkpoint CN.safetensors

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


def build_pipeline(args, device):
    """(pipe, text, uncond): the DualFlow pipeline on `device` in bf16
    (`--tiny` configs or SD-1.5's), its weights from `--sd_checkpoint_dir`
    / `--controlnet_checkpoint` where given (else PyTorch's initialisation
    from seed 0), and the prompt's and the negative prompt's embeddings
    [1, L, D] through the checkpoint's CLIP text encoder (zeros without
    one, as the JAX CLI)."""
    from diffcodec_tpu_torch.config import (CLIPTextConfig, ControlNetConfig,
                                            SamplerConfig, UNetConfig,
                                            VAEConfig)
    from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline

    dtype = torch.bfloat16
    unet_cfg = UNetConfig.tiny() if args.tiny else UNetConfig()
    cn_cfg = (ControlNetConfig.tiny() if args.tiny
              else ControlNetConfig(unet=unet_cfg))
    vae_cfg = (VAEConfig(base_channels=8, channel_mults=(1, 1, 2, 2),
                         layers_per_block=1) if args.tiny else VAEConfig())
    torch.manual_seed(0)
    pipe = DualFlowPipeline.create(
        unet_cfg, cn_cfg, vae_cfg, SamplerConfig(
            num_inference_steps=args.steps, guidance_scale=args.guidance,
            controlnet_conditioning_scale=args.cond_scale,
            controlnet_interval=args.cn_interval,
            unet_encoder_interval=args.enc_interval),
        dtype=dtype, device=device)
    if not args.sd_checkpoint_dir:
        text = torch.zeros((1, 77, unet_cfg.cross_attention_dim),
                           dtype=dtype, device=device)
        return pipe, text, text
    from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
    from diffcodec_tpu_torch.models.weights import load_sd_checkpoint_dir
    from diffcodec_tpu_torch.utils.tokenizer import default_tokenizer

    clip_cfg = CLIPTextConfig.tiny() if args.tiny else CLIPTextConfig()
    with torch.device(device):
        text_encoder = CLIPTextEncoder(clip_cfg).to(dtype).eval()
    load_sd_checkpoint_dir(
        args.sd_checkpoint_dir,
        {"unet": pipe.unet, "controlnet": pipe.controlnet, "vae": pipe.vae,
         "text": text_encoder},
        controlnet_path=args.controlnet_checkpoint or None)
    text, uncond = pipe.encode_prompt(
        text_encoder, default_tokenizer(clip_cfg.max_length), [args.prompt],
        [args.negative_prompt])
    return pipe, text, uncond


def make_sampler(pipe, text, uncond, seed: int, device):
    """`decode_video`'s sample_fn: the same seeded latent noise each call
    (as the JAX CLI's fixed key), CFG over the prompt embeddings."""
    gen = torch.Generator(device=device)

    def sample_fn(cond, flow):
        B, H, W = cond.shape[:3]
        gen.manual_seed(seed)
        latents = torch.randn((B, H // 8, W // 8, 4), generator=gen,
                              device=device)
        return pipe.sample(latents, text.expand(B, -1, -1),
                           uncond.expand(B, -1, -1), cond, flow)

    return sample_fn


def cmd_decode(args):
    from PIL import Image

    from diffcodec_tpu_torch.codec.runner import EncodedVideo, decode_video

    enc = EncodedVideo.load(args.bitstream)
    pipe, text, uncond = build_pipeline(args, args.device)
    out = decode_video(enc, make_sampler(pipe, text, uncond, args.seed,
                                         args.device),
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
