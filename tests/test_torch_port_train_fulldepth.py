"""The ControlNet training step at SD-1.5's real depth, JAX against the
port, on the CPU, in fp32 and in bf16 (`slow`).

`test_torch_port_train_fullwidth.py` at `layers_per_block=2`, no cut:
`UNetConfig()`, `ControlNetConfig()` (12 down zero-conv heads and the mid
head) and `VAEConfig()`, frames of 64 px, batch 2, `scripts/
bench_train.py`'s operating point; `train_parity.py` says how each run is
made and what is held to what.  Three variants, each with both optimizers
(fp32 and bf16 Adam moments): the DualFlow ControlNet with the MSE loss,
its optimizers also given JAX's fp32 gradient twice at the operating
point (element by element: the port's `Optimizer` against optax's chain,
clip over every tensor at once, the second update reading the moments as
each optimizer stored them); the same with the edge term (`edge_weight`
0.5: the backward through the VAE decoder); the residual ControlNet.

Read on an 8-core x86 host (torch 2.13.0+cpu, jax 0.9.0), `-s` printing
one JSON line a variant: fp32 gradients at most 0.18-0.21 of their
element limit, the moves 0.28-0.31, the optimizers given JAX's gradient
twice 0.075 (fp32 moments) and 0.186 (bf16), the DualFlow moves at the
operating point's eps 1e-8 from each package's own gradient 18 (printed
as 'fp32_operating', not held); bf16 gradient groups e_port
/ e_jax 0.92-1.12 (DualFlow), 0.89-1.16 (edge), 0.92-1.36 (residual: its
extractor 1.36, d / e_jax 1.75), the moves 0.91-1.05.  216 tests, 640-729 s
with a cold JAX cache, 20.2 GB of peak RSS.
"""

import pytest

import train_parity as tp

pytestmark = pytest.mark.slow

CFGS = tp.configs(layers_per_block=2)
VARIANTS = {
    "dualflow": tp.Variant("dualflow", alone=True),
    "edge": tp.Variant("edge", train=(("edge_weight", 0.5),)),
    "residual": tp.Variant("residual", residual=True),
}
GROUPS = {name: tp.groups(CFGS, v.residual) for name, v in VARIANTS.items()}
OPTS = sorted(tp.OPTIMIZERS)


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


@pytest.mark.parametrize("variant,opt", [
    (v, o) for v in sorted(VARIANTS) for o in OPTS])
def test_fp32_move_matches_jax_element_by_element(steps, variant, opt):
    got = steps[variant]["move"][opt]["fp32"]
    assert not got["past"] and got["worst"] <= 1.0, got


@pytest.mark.parametrize("opt", OPTS)
def test_optimizer_given_jaxs_gradient_matches_optax(steps, opt):
    got = steps["dualflow"]["move"][opt]["alone"]
    assert not got["past"] and got["worst"] <= 1.0, got


@pytest.mark.parametrize("variant,opt,group", [
    (v, o, g) for v in sorted(VARIANTS) for o in OPTS for g in GROUPS[v]])
def test_bf16_move_within_jax_rounding(steps, variant, opt, group):
    errors = steps[variant]["move"][opt]["bf16"][group]
    assert tp.bf16_holds(errors), (group, errors)


def test_full_depth_has_sd15s_heads():
    """12 down zero-conv heads and the mid head at full depth."""
    for name in VARIANTS:
        heads = [g for g in GROUPS[name] if g.startswith("head")]
        assert heads == [f"head{i}" for i in range(12)] + ["head_mid"], heads
