"""Export a trained checkpoint to the reference torch layout.

Counterpart: `scripts/export_checkpoint.py` (the same options).  Reads a
`checkpoint-N/state.pt` written by `cli.train_controlnet` (memory-mapped:
only the tensors written are read) and writes the ControlNet's fp32
masters as a `.safetensors` state dict under the reference
DualFlowControlNet tensor names (`flownet.py:23-47` module layout), so
checkpoints interchange with the torch pipeline (`validation.py:52-53`
loads this format) and with `run_codec --controlnet_checkpoint`.

  python -m diffcodec_tpu_torch.cli.export_checkpoint \\
      --checkpoint_dir runs/dualflow --out dualflow_controlnet.safetensors \\
      [--step 97000] [--tiny]

With --distilled the checkpoint dir is a `cli.train_distill` run: the
consistency student's EMA weights export as two state dicts,
`<out_dir>/controlnet.safetensors` (reference DualFlowControlNet names)
and `<out_dir>/unet.safetensors` (diffusers UNet2DConditionModel names).

  python -m diffcodec_tpu_torch.cli.export_checkpoint --distilled \\
      --checkpoint_dir runs/distill --out export_dir [--tiny]

The files are written by `utils/safetensors_io.py` (no `safetensors`
package needed); no device is used.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--distilled", action="store_true",
                    help="checkpoint_dir is a cli.train_distill run; "
                         "export the EMA student (controlnet + unet) "
                         "into the --out directory")
    return ap.parse_args(argv)


def _named(params, names, prefix=""):
    """{name: params[prefix + name]} for the map's `names`; every one must
    be in the checkpoint, and nothing else under `prefix`."""
    have = {n[len(prefix):] for n in params if n.startswith(prefix)}
    if have != set(names):
        raise SystemExit(
            f"the checkpoint's {prefix}* tensors are not those of the name "
            f"map (--tiny?): {sorted(have ^ set(names))[:5]}")
    return {n: params[prefix + n] for n in names}


def main(argv=None):
    args = parse_args(argv)

    from diffcodec_tpu_torch import weights as bridge
    from diffcodec_tpu_torch.cli.run_codec import model_configs
    from diffcodec_tpu_torch.train.checkpoint import restore_checkpoint
    from diffcodec_tpu_torch.utils.safetensors_io import save_file

    unet_cfg, cn_cfg, _, _ = model_configs(args.tiny)
    cn_names = [t for t, _, _ in bridge.controlnet_name_map(cn_cfg)]
    saved, step = restore_checkpoint(args.checkpoint_dir, args.step)
    if saved is None:
        raise SystemExit(f"no checkpoint under {args.checkpoint_dir}")

    if args.distilled:
        unet_names = [t for t, _, _ in bridge.unet_name_map(unet_cfg)]
        os.makedirs(args.out, exist_ok=True)
        for name, names in (("controlnet", cn_names), ("unet", unet_names)):
            path = os.path.join(args.out, f"{name}.safetensors")
            sd = _named(saved["ema_params"], names, name + ".")
            save_file(sd, path)
            print(f"exported student {name} (EMA, step {step}) -> {path} "
                  f"({len(sd)} tensors)")
        return

    sd = _named(saved["params"], cn_names)
    save_file(sd, args.out)
    print(f"exported checkpoint-{step} -> {args.out} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
