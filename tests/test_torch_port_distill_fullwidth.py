"""The consistency distillation step at SD-1.5's widths, JAX against the
port, on the CPU, in fp32.

Configs: `UNetConfig()` and `ControlNetConfig()` at their published widths
with one depth cut, `layers_per_block=1` (SD-1.5 has 2), as
`test_torch_port_train_fullwidth.py` cuts them; `VAEConfig()` whole (its
encoder runs in the step).  Frames of 64 px (8 x 8 latents), batch 2, at
`scripts/train_distill.py`'s point with the optimizer at lr 1e-3 and eps
1e-6; a teacher, a student and an EMA target with weights of their own.
`distill_parity.py` says how each run is made and what is held to what:
the loss to 1e-6, every student gradient element by element, and after
the update the masters, the EMA and Adam's two moments element by element.
The bf16 step is held at full depth (`test_torch_port_distill_
fulldepth.py`, `slow`).

Read on an 8-core x86 host (torch 2.13.0+cpu, jax 0.9.0, two torch
threads), `-s` printing one JSON line: the loss 6.0e-7 apart, every
gradient element at most 0.339 of its limit, the masters 0.418, the EMA
0.392, both moments 0.340.  ~187 s alone with a cold JAX cache, 21.7 GB
of peak RSS in the process that `compare_step` spawns for the step.
"""

import numpy as np
import pytest
import torch

import distill_parity as dp
import train_parity as tp
from chip_smoke import distill_group
from torch_threads import few_torch_threads

NETS = dp.Nets(tp.configs(layers_per_block=1))


_few_torch_threads = few_torch_threads(2)


@pytest.fixture(scope="module")
def step():
    """`distill_parity.compare_step`'s result in fp32."""
    return dp.compare_step(NETS.cfgs, ("fp32",))


def test_fp32_loss_matches_jax(step):
    assert tp.loss_holds(step["loss"], "fp32"), step["loss"]


def test_fp32_gradient_matches_jax_element_by_element(step):
    got = step["grad"]["fp32"]
    assert not got["past"] and got["worst"] <= 1.0, got


@pytest.mark.parametrize("tree", ["params", "ema", "mu", "nu"])
def test_fp32_update_matches_jax_element_by_element(step, tree):
    got = step["move"]["fp32"][tree]
    assert not got["past"] and got["worst"] <= 1.0, (tree, got)


def test_groups_cover_every_parameter():
    """Each student parameter falls in one group: the UNet's input, 4 down
    blocks, mid block, 4 up blocks and out head; the ControlNet's
    extractor, input, FDNs, 4 down blocks, mid block, 8 down heads and mid
    head."""
    got = list(dict.fromkeys(distill_group(n) for n in NETS.names))
    unet = {"input", "mid", "out"} | {f"{d}{i}" for d in ("down", "up")
                                      for i in range(4)}
    cn = {"extractor", "input", "fdn", "mid", "head_mid"} | {
        f"down{i}" for i in range(4)} | {f"head{i}" for i in range(8)}
    assert set(got) == {f"unet.{g}" for g in unet} | {
        f"controlnet.{g}" for g in cn}, got


def test_networks_have_weights_of_their_own():
    """The teacher, the student and the EMA target differ at every tensor
    (so that a network used in another's place shows), and a leaf drawn
    again alone is the same."""
    for name in ("unet.conv_in.weight", "controlnet.controlnet_mid_block.bias",
                 "unet.up_blocks.1.attentions.0.transformer_blocks.0."
                 "attn2.to_k.weight"):
        drawn = {r: NETS.torch_leaf(s, name) for r, s in dp.ROLES.items()}
        for a, b in (("teacher", "student"), ("student", "target"),
                     ("teacher", "target")):
            assert not np.allclose(drawn[a], drawn[b]), (name, a, b)
        assert torch.equal(drawn["student"],
                           NETS.torch_leaf(dp.ROLES["student"], name))
