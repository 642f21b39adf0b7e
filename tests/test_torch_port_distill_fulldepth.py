"""The consistency distillation step at SD-1.5's real depth, JAX against the
port, on the CPU, in fp32 and in bf16 (`slow`).

`test_torch_port_distill_fullwidth.py` at `layers_per_block=2`, no cut:
`UNetConfig()`, `ControlNetConfig()` (12 down zero-conv heads and the mid
head) and `VAEConfig()`; `distill_parity.py` says how each run is made and
what is held to what.  fp32 element by element against JAX's fp32: the
loss to 1e-6; every student gradient at `DEPTH_SCALE` (5) times the
element limits, which fp32 rounding alone exceeds at this depth; the
masters, the EMA and Adam's moments after the port's update of JAX's own
gradient at the limits themselves.  bf16 by `chip_smoke.within_bf16_rule`
against JAX's fp32 and bf16 runs: by group and whole the gradient, the
masters' move and the EMA's move, and the loss's terms; the loss, their
mean, within `chip_smoke.mean_limit` of JAX's fp32.  A tree of the
student's size is 5.1 GB here: JAX's steps run once for each of two parts of the
tensors (`PARTS`), so that only one part of JAX's fp32 results is held
beside its bf16 step.

Read on an 8-core x86 host (eight torch threads, cold JAX cache): 462 s,
43.3 GB peak RSS; the fp32 gradient 0.682 of its limit (3.41x the
element limits), the update given JAX's gradient at most 0.352 of its
limits; bf16 e_port / e_jax 0.50-0.76 by group, the loss 1.42e-3 off
JAX's fp32 against a `mean_limit` of 8.1e-3.  A fault planted in a copy
of the port (two of the UNet's twelve ControlNet residuals swapped, which
only SD-1.5's depth has) read the fp32 gradient 2181x its limit.
"""

import pytest

import distill_parity as dp
import train_parity as tp
from chip_smoke import distill_group

pytestmark = pytest.mark.slow

NETS = dp.Nets(tp.configs(layers_per_block=2))
GROUPS = list(dict.fromkeys(distill_group(n) for n in NETS.names)) + ["all"]
PARTS = 2


@pytest.fixture(scope="module")
def step():
    """`distill_parity.compare_step`'s result in fp32 and bf16."""
    return dp.compare_step(NETS.cfgs, ("fp32", "bf16"), parts=PARTS, deep=True)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_loss_matches_jax(step, dtype):
    assert dp.loss_holds(step, dtype), (step["loss"], dp.loss_bf16(step))


def test_bf16_loss_terms_within_jax_rounding(step):
    errors = dp.terms_errors(step["terms"])
    assert tp.bf16_holds(errors), errors


def test_fp32_gradient_matches_jax_element_by_element(step):
    got = step["grad"]["fp32"]
    assert not got["past"] and got["worst"] <= 1.0, got


@pytest.mark.parametrize("tree", ["params", "ema", "mu", "nu"])
def test_fp32_update_matches_jax_element_by_element(step, tree):
    got = step["move"]["fp32"][tree]
    assert not got["past"] and got["worst"] <= 1.0, (tree, got)


@pytest.mark.parametrize("group", GROUPS)
def test_bf16_gradient_within_jax_rounding(step, group):
    errors = step["grad"]["bf16"][group]
    assert tp.bf16_holds(errors), (group, errors)


@pytest.mark.parametrize("tree,group", [
    (t, g) for t in ("params", "ema") for g in GROUPS])
def test_bf16_move_within_jax_rounding(step, tree, group):
    errors = step["move"]["bf16"][tree][group]
    assert tp.bf16_holds(errors), (tree, group, errors)


def test_full_depth_has_sd15s_heads():
    """12 down zero-conv heads and the mid head at full depth."""
    heads = [g for g in GROUPS if g.startswith("controlnet.head")]
    assert heads == [f"controlnet.head{i}" for i in range(12)] + [
        "controlnet.head_mid"], heads
