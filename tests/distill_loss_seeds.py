"""Is the port's bf16 distillation loss biased against JAX's, or is its
distance from the fp32 loss chance?  A script, not a test:

    python tests/distill_loss_seeds.py [--config tiny|lpb1|lpb2]
                                       [--seeds 0,1,2] [--threads 6]

For each seed, the loss of one distillation step (`distill_parity.py`'s
setting: DistillConfig's defaults, 64 px, batch 2; seed 0 is its own
weights, batch and key, the others draw all of them anew) and its terms,
the Huber of f_student - f_target element by element: JAX's jitted
loss_fn in fp32 and in bf16 (its posterior eps drawn in fp32 and rounded,
as there), the port's in fp32 and bf16, fed JAX's draws.  `tiny` is the
tiny configs (the VAE cut as in `test_torch_port_distill.py`), `lpbN`
SD-1.5's widths at N layers a block (`lpb2`: SD-1.5 whole).  The loss is
the terms' mean, so a bf16 run's distance from its package's fp32 loss is
the mean of its terms' errors; per seed each package's signed distance in
standard errors of that mean (the sd of its terms' errors over sqrt(N)),
and relative to the loss; then over the seeds their mean and rms.
Rounding that cancels by chance reads a mean near 0 and an rms near 1 in
standard errors; a bias reads a mean away from 0.  One JSON line a seed,
then the summary.
"""

import argparse
import gc
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import conftest  # noqa: E402,F401  JAX on the CPU, its compile cache
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import distill_parity as dp  # noqa: E402
import train_parity as tp  # noqa: E402
from chip_smoke import distill_loss_terms  # noqa: E402
from diffcodec_tpu import config as jcfg  # noqa: E402
from diffcodec_tpu_torch import config as tcfg  # noqa: E402


def configs(name: str) -> tp.Configs:
    if name == "tiny":
        kw = dict(base_channels=8, channel_mults=(1, 1, 2, 2),
                  layers_per_block=1)
        return tp.Configs(jcfg.UNetConfig.tiny(), jcfg.ControlNetConfig.tiny(),
                          jcfg.VAEConfig(**kw), tcfg.UNetConfig.tiny(),
                          tcfg.ControlNetConfig.tiny(), tcfg.VAEConfig(**kw))
    return tp.configs(layers_per_block=int(name[3:]))


def jax_programs(cfgs) -> dict:
    """{dtype: jitted (loss, terms) of JAX's loss_fn at the step's key}."""
    out = {}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        loss_fn = dp.loss_and_terms(dp._jax_distiller(cfgs, dtype))
        out[name] = jax.jit(lambda s, e, f, b, rng, fn=loss_fn: fn(
            s, e, f, b, jax.random.fold_in(rng, 0)))
    return out


def one_seed(nets: dp.Nets, programs: dict, seed: int) -> dict:
    roles = {k: v + 1000 * seed for k, v in dp.ROLES.items()}
    vae_seed = dp.VAE_SEED + 1000 * seed
    batch = dp.batch(nets.cfgs.ju.cross_attention_dim, dp.BATCH_SEED + seed)
    rng = jax.random.PRNGKey(dp.KEY + seed)
    drawn = dp.draws(rng, jcfg.DistillConfig().num_teacher_steps)
    runs = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for name, low in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        student = nets.jax_tree(roles["student"])
        ema = nets.jax_tree(roles["target"])
        frozen = dict(nets.jax_tree(roles["teacher"], dtype=low),
                      **nets.jax_tree(vae_seed, ("vae",), low))
        if name == "bf16":
            with tp._eps_drawn_in_fp32():
                loss, terms = programs[name](student, ema, frozen, jb, rng)
        else:
            loss, terms = programs[name](student, ema, frozen, jb, rng)
        runs[f"jax_{name}"] = (float(loss), np.asarray(terms, np.float64))
        del student, ema, frozen, loss, terms
        gc.collect()
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        d = dp.port_distiller(nets, dtype, roles, vae_seed)
        with torch.no_grad():
            loss, terms = distill_loss_terms(d, dp.port_batch(batch, dtype),
                                             drawn)
        runs[f"port_{name}"] = (loss.item(), terms.double().numpy())
        del d, loss, terms
        gc.collect()
    tp._trim()
    out = dict(seed=seed, loss=runs["jax_fp32"][0],
               fp32_gap=(runs["port_fp32"][0] - runs["jax_fp32"][0])
               / abs(runs["jax_fp32"][0]))
    for pkg in ("jax", "port"):
        l32, t32 = runs[f"{pkg}_fp32"]
        l16, t16 = runs[f"{pkg}_bf16"]
        diff = (t16 - t32).ravel()
        se = diff.std() / math.sqrt(diff.size)
        out[pkg] = dict(rel=(l16 - l32) / abs(l32), z=(l16 - l32) / se,
                        terms=diff.size)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="tiny")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--threads", type=int, default=6)
    args = p.parse_args()
    torch.set_num_threads(args.threads)
    nets = dp.Nets(configs(args.config))
    programs = jax_programs(nets.cfgs)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(one_seed(nets, programs, seed))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for pkg in ("jax", "port"):
        for key in ("z", "rel"):
            v = [r[pkg][key] for r in rows]
            summary[f"{pkg}_{key}"] = dict(
                mean=sum(v) / len(v),
                rms=math.sqrt(sum(a * a for a in v) / len(v)))
    print(json.dumps(dict(config=args.config, seeds=len(rows),
                          summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
