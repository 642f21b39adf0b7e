"""The ControlNet training step at SD-1.5's widths, JAX against the port,
on the CPU, in fp32 and in bf16.

Configs: `UNetConfig()` and `ControlNetConfig()` at their published widths
with one depth cut, `layers_per_block=1` (SD-1.5 has 2), as
`test_torch_port_fullwidth.py` cuts them: block widths 320/640/1280/1280,
8 heads of 40/80/160, cross-attention over 77 x 768 tokens, the
ControlNet's inject widths, 8 down zero-conv heads and the mid head.
`VAEConfig()` whole (its encoder runs in the step).  Frames of 64 px (8 x
8 latents), batch 2, at `scripts/bench_train.py`'s operating point:
AdamW at lr 1e-5, weight decay 1e-2, clip 1.0, bf16 over fp32 ControlNet
masters with the frozen UNet and VAE in bf16.  `train_parity.py` says how
each run is made and what is held to what.

The DualFlow ControlNet with the MSE loss: its loss, its gradient and the
masters after one update by each optimizer (fp32 and bf16 Adam moments)
from each package's fp32 gradient.  The moves from the bf16 runs, the
edge term and the residual ControlNet are held at full depth
(`test_torch_port_train_fulldepth.py`, `slow`): with them this file read
206 s alone and 1254 s in the six-process lane, which it took to 1447 s
of its 1470.

fp32: the loss to 1e-6, every gradient element at 1e-4 (plus 1e-6 of the
largest gradient), every master's move after one update to 2% of lr at
`test_torch_port_train.py`'s optimizer (lr 1e-3, decay 0.1, eps 1e-6); at
the operating point's eps 1e-8 Adam's step g / (|g| + eps) turns the
gradients' summation-order differences into up to 0.36 lr where |g|
nears eps (the slow file prints it as 'fp32_operating', and holds the
moves there in bf16 by groups and element by element given JAX's
gradient).  bf16: every gradient group
and the whole gradient by `chip_smoke.within_bf16_rule`; the loss within
`TRAIN_REF_TOL`'s 2% of JAX's fp32 loss.

Read on an 8-core x86 host (torch 2.13.0+cpu, jax 0.9.0), `-s` prints
one JSON line.  With two torch threads: fp32 gradients at most 0.629 of
their limit, moves 0.340; bf16 gradient e_jax 0.014-0.045 by group,
e_port / e_jax 0.93-1.05, d / e_jax 0.77-1.16.  With eight: 0.146,
0.468, 0.77-1.03 (the extractor 0.77), 0.84-1.16, the fp32 loss 1.8e-7
apart (the port's CPU sums in another order with another thread count).
The file took 160-166 s alone with a cold JAX cache (its JAX programs
lowered first and compiled on threads), 426 s of CPU time, 12.0 GB of
peak RSS; 411 s in the six-process lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_parity as tp
from test_torch_port_fullwidth import rel_l2
from torch_threads import few_torch_threads

CFGS = tp.configs(layers_per_block=1)
VARIANTS = {"dualflow": tp.Variant("dualflow", bf16_moves=False)}
GROUPS = {name: tp.groups(CFGS, v.residual) for name, v in VARIANTS.items()}


_few_torch_threads = few_torch_threads(2)


@pytest.fixture(scope="module")
def steps():
    """{variant: `train_parity.compare_step`'s result}."""
    programs = tp._Programs()
    for v in VARIANTS.values():
        tp.start_programs(programs, CFGS, v)
    return {name: tp.compare_step(CFGS, v, programs)
            for name, v in VARIANTS.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp32_loss_matches_jax(steps, variant):
    assert tp.loss_holds(steps[variant]["loss"], "fp32"), steps[variant][
        "loss"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fp32_gradient_matches_jax_element_by_element(steps, variant):
    got = steps[variant]["grad"]["fp32"]
    assert not got["past"] and got["worst"] <= 1.0, got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_loss_within_limit(steps, variant):
    assert tp.loss_holds(steps[variant]["loss"], "bf16"), steps[variant][
        "loss"]


@pytest.mark.parametrize("variant,group", [
    (v, g) for v in sorted(VARIANTS) for g in GROUPS[v]])
def test_bf16_gradient_within_jax_rounding(steps, variant, group):
    errors = steps[variant]["grad"]["bf16"][group]
    assert tp.bf16_holds(errors), (group, errors)


@pytest.mark.parametrize("opt", sorted(tp.OPTIMIZERS))
def test_fp32_move_matches_jax_element_by_element(steps, opt):
    got = steps["dualflow"]["move"][opt]["fp32"]
    assert not got["past"] and got["worst"] <= 1.0, got


def test_groups_cover_every_parameter():
    """Each ControlNet parameter falls in one group: the extractor (the
    residual ControlNet's residue and warp extractors), the input, the
    FDNs, 4 down blocks, the mid block, 8 down heads and the mid head."""
    want = {"extractor", "input", "fdn", "mid", "head_mid", "all"} | {
        f"down{i}" for i in range(4)} | {f"head{i}" for i in range(8)}
    for name in VARIANTS:
        got = GROUPS[name]
        assert got[-1] == "all" and len(set(got)) == len(got) == len(want)
        assert set(got) == want, (name, got)


def test_jax_draws_the_posterior_eps_anew_in_bf16():
    """Why JAX's bf16 run is traced with the eps drawn in fp32: at one key
    `jax.random.normal` in bf16 is another sample (relL2 ~1.41 from the
    fp32 draw, two independent normals), not its rounding (~2^-9)."""
    key = jax.random.split(jax.random.PRNGKey(7), 3)[2]
    shape = (tp.B, tp.H // 8, tp.H // 8, 4)
    f32 = np.asarray(jax.random.normal(key, shape, jnp.float32))
    bf16 = np.asarray(jax.random.normal(key, shape, jnp.bfloat16),
                      np.float32)
    rounded = f32.astype(jnp.bfloat16).astype(np.float32)
    assert rel_l2(bf16, f32) > 1.0
    assert rel_l2(rounded, f32) < 2.0 ** -8
