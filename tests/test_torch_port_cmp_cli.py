"""The port's CMP experiment configs (`train/cmp_config.py`) and training
CLI (`cli/train_cmp.py`) against the JAX package's
`train/cmp_config.py` and `scripts/train_cmp.py`, on the CPU.

The YAML strings are `tests/test_cmp_config.py`'s (copied, not imported):
the shipped resnet50_vip+mpii_liteflow config, a rep_learning AlexNet
config and a tiny one.  The CLI runs beside JAX's script on the tiny one
with `--synthetic 6 --crop 64`: each step's batch bit-identical, the
first step's loss from the same weights to 1e-4, rotation and resume.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffcodec_tpu.train import cmp_config as jconfig
from diffcodec_tpu.train import cmp_train as jtrain

from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.cli import train_cmp
from diffcodec_tpu_torch.train import checkpoint, cmp_config, cmp_train

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)
import train_cmp as jscript  # noqa: E402  (scripts/)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (the lane runs six test
    processes on the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHIPPED_YAML = """
model:
    arch: CMP
    total_iter: 42000
    lr_steps: [24000, 36000]
    lr_mults: [0.1, 0.1]
    lr: 0.1
    optim: SGD
    warmup_lr: []
    warmup_steps: []
    module:
        arch: CMP
        image_encoder: resnet50
        sparse_encoder: shallownet8x
        flow_decoder: MotionDecoderSkipLayer
        skip_layer: True
        img_enc_dim: 256
        sparse_enc_dim: 16
        output_dim: 198
        decoder_combo: [1,2,4]
        pretrained_image_encoder: False
        flow_criterion: "DiscreteLoss"
        nbins: 99
        fmax: 50
data:
    workers: 2
    batch_size: 8
    short_size: 416
    crop_size: [384, 384]
    sample_strategy: ['grid', 'watershed']
    sample_bg_ratio: 5.74e-5
    nms_ks: 41
    max_num_guide: -1
trainer:
    initial_val: True
    print_freq: 100
    val_freq: 5000
    save_freq: 5000
    loss_record: ['loss_flow']
    tensorboard: True
"""

ALEXNET_YAML = """
model:
    total_iter: 140000
    lr_steps: [80000, 120000]
    lr_mults: [0.1, 0.1]
    lr: 0.1
    optim: SGD
    warmup_lr: [0.4]
    warmup_steps: [10000]
    module:
        image_encoder: alexnet_fcn_32x
        sparse_encoder: shallownet32x
        flow_decoder: MotionDecoderPlain
        skip_layer: False
        img_enc_dim: 256
        sparse_enc_dim: 16
        output_dim: 198
        decoder_combo: [1]
        flow_criterion: "DiscreteLoss"
        nbins: 99
        fmax: 50
data:
    batch_size: 12
"""

TINY_YAML = """
model:
    total_iter: 3
    lr_steps: [2]
    lr_mults: [0.1]
    lr: 0.05
    optim: SGD
    module:
        image_encoder: resnet50
        sparse_encoder: shallownet8x
        flow_decoder: MotionDecoderSkipLayer
        skip_layer: True
        img_enc_dim: 16
        sparse_enc_dim: 4
        output_dim: 18
        decoder_combo: [1,2,4]
        flow_criterion: "DiscreteLoss"
        nbins: 9
        fmax: 50
data:
    batch_size: 2
    crop_size: [64, 64]
    sample_strategy: ['grid']
    sample_bg_ratio: 0.01
    nms_ks: 5
    max_num_guide: -1
trainer:
    print_freq: 1
    val_freq: 100
    save_freq: 2
"""

YAMLS = {"shipped": SHIPPED_YAML, "alexnet": ALEXNET_YAML, "tiny": TINY_YAML,
         # the shipped config with the other two decoders
         "plain": SHIPPED_YAML.replace("MotionDecoderSkipLayer",
                                       "MotionDecoderPlain"),
         "flownet": SHIPPED_YAML.replace("MotionDecoderSkipLayer",
                                         "MotionDecoderFlowNet")}


@pytest.mark.parametrize("name", list(YAMLS))
def test_configs_parse_as_jaxs(name, tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text(YAMLS[name])
    got = cmp_config.load_cmp_config(str(path))
    want = jconfig.load_cmp_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    model = cmp_config.build_cmp_model(got)
    jmodel = jconfig.build_cmp_model(want)
    assert (model.backbone, model.decoder, model.combo, model.nbins) == (
        jmodel.backbone, jmodel.decoder, jmodel.combo, jmodel.nbins)
    s = got.schedule
    jsched = jtrain.cmp_lr_schedule(s.lr, s.lr_steps, s.lr_mults,
                                    warmup_lr=s.warmup_lr,
                                    warmup_steps=s.warmup_steps)
    sched = cmp_config.build_cmp_optimizer(got).lr
    for step in (0, 1, 5000, 9999, 10000, 24000, 36000, 80000, 120000):
        assert sched(step) == float(jax.jit(jsched)(jnp.int32(step)))


@pytest.mark.parametrize("mutate, match", [
    ({"sparse_encoder": "shallownet32x"}, "pairs with"),
    ({"image_encoder": "vgg16"}, "unknown image_encoder"),
    ({"flow_decoder": "MotionDecoderBogus"}, "unknown flow_decoder"),
    ({"output_dim": 100}, "2\\*nbins"),
    ({"flow_criterion": "L1"}, "DiscreteLoss"),
])
def test_rejections_are_jaxs(mutate, match):
    raw = yaml.safe_load(SHIPPED_YAML)
    raw["model"]["module"].update(mutate)
    with pytest.raises(ValueError, match=match) as want:
        jconfig.parse_cmp_config(raw)
    with pytest.raises(ValueError, match=match) as got:
        cmp_config.parse_cmp_config(raw)
    assert str(got.value) == str(want.value)


def test_optimizer_other_than_sgd_is_rejected_as_jax_does():
    raw = yaml.safe_load(SHIPPED_YAML)
    raw["model"]["optim"] = "Adam"
    with pytest.raises(ValueError) as want:
        jconfig.parse_cmp_config(raw)
    with pytest.raises(ValueError) as got:
        cmp_config.parse_cmp_config(raw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", list(YAMLS))
def test_json_config_parses_without_yaml(name, tmp_path, monkeypatch):
    """The card's machine has no PyYAML: the same dict written as JSON
    parses to the same config with `yaml` unimportable."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(yaml.safe_load(YAMLS[name])))
    want = jconfig.load_cmp_config(str(path))  # JSON is YAML
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = cmp_config.load_cmp_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(YAMLS[name])
    with pytest.raises(ImportError):
        cmp_config.load_cmp_config(str(yaml_path))


def test_cli_matches_jax_script(tmp_path, monkeypatch, capsys):
    """Both CLIs on the tiny config, `--synthetic 6 --crop 64`, the port's
    model filled with the variables JAX's script initialises: every step's
    batch bit-identical, the first step's printed loss within 1e-4
    relative and the later ones within 1e-2 (each package follows its own
    fp32 gradient, which a random initialisation leaves ill-conditioned:
    `test_torch_port_cmp_train.py` holds the steps in float64),
    checkpoints 2 and 3, and a resume to iter 5 from a state
    bit-identical to the one saved."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    args = ["--config", str(cfg_path), "--synthetic", "6", "--crop", "64"]

    class Recorder:  # JAX's batches: the loop's jnp.asarray calls
        def __init__(self):
            self.seen = []

        def __getattr__(self, name):
            return getattr(jnp, name)

        def asarray(self, x, *a, **k):
            self.seen.append(np.array(x))
            return jnp.asarray(x, *a, **k)

    rec = Recorder()
    monkeypatch.setattr(jscript, "jnp", rec)
    jout = str(tmp_path / "jax")
    jscript.main(args + ["--output_dir", jout])
    jtext = capsys.readouterr().out
    jbatches = [dict(zip(("image", "sparse", "flow_target"),
                         rec.seen[i:i + 3]))
                for i in range(0, len(rec.seen), 3)]

    cfg = jconfig.load_cmp_config(str(cfg_path))
    jmodel = jconfig.build_cmp_model(cfg)
    init = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                jnp.zeros((2, 64, 64, 3)),
                                jnp.zeros((2, 64, 64, 4)))
    init = jax.tree.map(np.asarray, init)
    build = train_cmp.build
    trainers = []

    def build_from_jax_init(cfg, seed, device):
        trainer = build(cfg, seed, device)
        weights.load_cmp_params(trainer.model, init)
        trainers.append(trainer)
        return trainer

    batches = []

    def make_batch(*a):
        b = train_cmp_make_batch(*a)
        batches.append(b)
        return b

    train_cmp_make_batch = train_cmp.make_batch
    monkeypatch.setattr(train_cmp, "build", build_from_jax_init)
    monkeypatch.setattr(train_cmp, "make_batch", make_batch)
    out = str(tmp_path / "port")
    train_cmp.main(args + ["--output_dir", out, "--device", "cpu"])
    text = capsys.readouterr().out

    assert len(batches) == len(jbatches) == 3
    for got, want in zip(batches, jbatches):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    def losses(t):
        return [float(line.split("loss_flow=")[1].split()[0])
                for line in t.splitlines() if line.startswith("iter ")]

    assert [line.split()[1] for line in text.splitlines()
            if line.startswith("iter ")] == ["1/3", "2/3", "3/3"]
    got_l, want_l = losses(text), losses(jtext)
    assert len(got_l) == len(want_l) == 3 and np.isfinite(got_l).all()
    # the first step's loss to 1e-4 (it lands 3.7e-5 apart); the later
    # steps' to 1e-2 (1.5e-3 and 2.8e-3 apart)
    np.testing.assert_allclose(got_l[0], want_l[0], rtol=1e-4)
    np.testing.assert_allclose(got_l[1:], want_l[1:], rtol=1e-2)
    assert f"saved {out}/checkpoint-2" in text and text.endswith("done\n")
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == [
        "checkpoint-2", "checkpoint-3"]

    saved, step = checkpoint.restore_checkpoint(out)
    assert step == 3 and saved["opt_state"]["count"] == 3
    restored = []
    load = cmp_train.CMPTrainer.load_state_dict

    def load_and_keep(self, state):
        load(self, state)
        restored.append(checkpoint._map_tensors(
            self.state_dict(), lambda t: t.detach().clone()))
        return self

    monkeypatch.setattr(cmp_train.CMPTrainer, "load_state_dict",
                        load_and_keep)
    train_cmp.main(args + ["--output_dir", out, "--device", "cpu",
                           "--total_iter", "5", "--resume", "latest"])
    text = capsys.readouterr().out
    assert "resumed from checkpoint-3" in text
    assert [line.split()[1] for line in text.splitlines()
            if line.startswith("iter ")] == ["4/5", "5/5"]
    (state,) = restored
    assert state["opt_state"]["count"] == 3
    for key in ("params", "batch_stats"):
        assert set(state[key]) == set(saved[key])
        for n, t in saved[key].items():
            assert torch.equal(state[key][n], t), n
    for n, t in saved["opt_state"]["trace"].items():
        assert torch.equal(state["opt_state"]["trace"][n], t), n
    # the sampler continued after the restored step: the resumed run's
    # batches are the uninterrupted order's 4th and 5th
    order = cmp_train.distributed_given_iteration_indices(6, 5, 2, 1, 0)
    np.testing.assert_array_equal(batches[3]["flow_target"],
                                  _flows()[order[6:8]])
    assert sorted(os.listdir(out))[-1] == "checkpoint-5"


def _flows():
    """The synthetic bank's flows, as both CLIs draw them (seed 0)."""
    _, flows = train_cmp._synthetic_bank(6, 64, np.random.default_rng(0))
    return flows
