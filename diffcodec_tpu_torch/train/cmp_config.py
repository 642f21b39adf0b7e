"""CMP experiment configs in the reference's YAML schema.

Counterpart: `diffcodec_tpu/train/cmp_config.py` (the dataclasses :46-106,
`_pick` :109, `parse_cmp_config` :121, `load_cmp_config` :133, `_validate`
:141, `build_cmp_model` :166, `build_cmp_optimizer` :180), written anew
because that module imports the flax CMP and `cmp_train` at module level.
The reference configures CMP runs with experiment files
(`cmp/experiments/semiauto_annot/resnet50_vip+mpii_liteflow/config.yaml`
and the six rep_learning configs) with sections `model` (the schedule and
the `module` architecture), `data` and `trainer`; this module parses that
schema into frozen dataclasses and builds the port's CMP and its SGD.

Name mapping (reference -> here):
  image_encoder resnet50 / alexnet_fcn_32x / alexnet_fcn_8x
      -> `models.cmp.CMP`'s backbone
  sparse_encoder shallownet8x / shallownet32x
      -> derived from the backbone (a mismatched pair is rejected)
  flow_decoder MotionDecoderSkipLayer / MotionDecoderPlain /
      MotionDecoderFlowNet -> decoder 'skip' / 'plain' / 'flownet'
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

_DECODERS = {
    "MotionDecoderSkipLayer": "skip",
    "MotionDecoderPlain": "plain",
    "MotionDecoderFlowNet": "flownet",
}

# the sparse encoder the reference pairs with each backbone
# (config.yaml:12-13; cmp/models/backbone/alexnet.py:62-63)
_SPARSE_FOR_BACKBONE = {
    "resnet50": "shallownet8x",
    "alexnet_fcn_32x": "shallownet32x",
    "alexnet_fcn_8x": "shallownet8x",
}


@dataclasses.dataclass(frozen=True)
class CMPModuleConfig:
    """`model.module` section (architecture)."""
    image_encoder: str = "resnet50"
    sparse_encoder: str = "shallownet8x"
    flow_decoder: str = "MotionDecoderSkipLayer"
    skip_layer: bool = True
    img_enc_dim: int = 256
    sparse_enc_dim: int = 16
    output_dim: int = 198
    decoder_combo: Tuple[int, ...] = (1, 2, 4)
    flow_criterion: str = "DiscreteLoss"
    nbins: int = 99
    fmax: float = 50.0


@dataclasses.dataclass(frozen=True)
class CMPScheduleConfig:
    """`model` section minus `module` (optimizer + LR schedule)."""
    total_iter: int = 42000
    lr: float = 0.1
    lr_steps: Tuple[int, ...] = (24000, 36000)
    lr_mults: Tuple[float, ...] = (0.1, 0.1)
    optim: str = "SGD"
    warmup_lr: Tuple[float, ...] = ()
    warmup_steps: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class CMPDataConfig:
    """`data` section (the knobs the training loop uses; the worker and
    memcached fields are the torch DataLoader's and ignored)."""
    batch_size: int = 8
    data_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    data_div: Tuple[float, ...] = (58.395, 57.12, 57.375)
    short_size: int = 416
    crop_size: Tuple[int, int] = (384, 384)
    sample_strategy: Tuple[str, ...] = ("grid", "watershed")
    sample_bg_ratio: float = 5.74e-5
    nms_ks: int = 41
    max_num_guide: int = -1
    train_source: Tuple[str, ...] = ()
    val_source: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class CMPTrainerConfig:
    """`trainer` section (logging/validation cadence)."""
    initial_val: bool = True
    print_freq: int = 100
    val_freq: int = 5000
    save_freq: int = 5000
    loss_record: Tuple[str, ...] = ("loss_flow",)
    tensorboard: bool = True


@dataclasses.dataclass(frozen=True)
class CMPExperimentConfig:
    module: CMPModuleConfig = CMPModuleConfig()
    schedule: CMPScheduleConfig = CMPScheduleConfig()
    data: CMPDataConfig = CMPDataConfig()
    trainer: CMPTrainerConfig = CMPTrainerConfig()


def _pick(d: Dict, cls, **extra):
    """`cls` from the keys of `d` that are its fields, lists as tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in d.items() if k in names}
    kw.update(extra)
    return cls(**kw)


def parse_cmp_config(raw: Dict) -> CMPExperimentConfig:
    """Parse an already-loaded config dict in the reference schema."""
    model = dict(raw.get("model", {}))
    module = _pick(dict(model.pop("module", {})), CMPModuleConfig)
    schedule = _pick(model, CMPScheduleConfig)
    data = _pick(dict(raw.get("data", {})), CMPDataConfig)
    trainer = _pick(dict(raw.get("trainer", {})), CMPTrainerConfig)
    cfg = CMPExperimentConfig(module=module, schedule=schedule, data=data,
                              trainer=trainer)
    _validate(cfg)
    return cfg


def load_cmp_config(path: str) -> CMPExperimentConfig:
    """Load a reference-format CMP experiment file.  A file that parses as
    JSON is read with `json` (JSON is YAML, so the JAX package's YAML loader
    reads it to the same dict); any other with PyYAML, imported here."""
    with open(path) as f:
        text = f.read()
    try:
        raw = json.loads(text)
    except ValueError:
        import yaml
        raw = yaml.safe_load(text)
    return parse_cmp_config(raw)


def _validate(cfg: CMPExperimentConfig) -> None:
    m = cfg.module
    if m.image_encoder not in _SPARSE_FOR_BACKBONE:
        raise ValueError(f"unknown image_encoder {m.image_encoder!r}")
    want_sparse = _SPARSE_FOR_BACKBONE[m.image_encoder]
    if m.sparse_encoder != want_sparse:
        raise ValueError(
            f"{m.image_encoder} pairs with {want_sparse} in the reference "
            f"configs, got {m.sparse_encoder!r}")
    if m.flow_decoder not in _DECODERS:
        raise ValueError(f"unknown flow_decoder {m.flow_decoder!r}")
    if m.output_dim != 2 * m.nbins:
        raise ValueError(
            f"output_dim ({m.output_dim}) must be 2*nbins ({2 * m.nbins}) "
            f"for the DiscreteLoss head")
    if m.flow_criterion != "DiscreteLoss":
        raise ValueError(
            f"only DiscreteLoss is shipped (the reference's semiauto_annot "
            f"+ rep_learning configs all use it); got {m.flow_criterion!r}")
    if cfg.schedule.optim.upper() != "SGD":
        raise ValueError(f"reference CMP optimizer is SGD, "
                         f"got {cfg.schedule.optim!r}")


def build_cmp_model(cfg: CMPExperimentConfig):
    """The port's CMP (fp32, on the CPU, PyTorch's initialisation from the
    global generator) for a parsed experiment config."""
    from diffcodec_tpu_torch.models.cmp import CMP

    m = cfg.module
    return CMP(img_enc_dim=m.img_enc_dim, sparse_enc_dim=m.sparse_enc_dim,
               nbins=m.nbins, fmax=float(m.fmax), backbone=m.image_encoder,
               decoder=_DECODERS[m.flow_decoder],
               combo=tuple(m.decoder_combo))


def build_cmp_optimizer(cfg: CMPExperimentConfig, momentum: float = 0.9,
                        weight_decay: float = 1e-4):
    """SGD with momentum on the config's step schedule (with its warmup
    knots where it has them, as the rep_learning configs do)."""
    from diffcodec_tpu_torch.train.cmp_train import SGD, cmp_lr_schedule

    s = cfg.schedule
    return SGD(cmp_lr_schedule(s.lr, s.lr_steps, s.lr_mults,
                               warmup_lr=s.warmup_lr,
                               warmup_steps=s.warmup_steps),
               momentum, weight_decay)
