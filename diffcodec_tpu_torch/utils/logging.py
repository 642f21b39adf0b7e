"""Logging, meters and step timing for the training CLIs.

Counterpart: `diffcodec_tpu/utils/logging.py` (`create_logger`,
`AverageMeter`, `StepTimer`, `MetricsLogger`; the reference's
`cmp/utils/common_utils.py:8-60` and `train_controlnet.py:762-774`).  The
metrics go to stdout lines, as there; wandb is optional and falls back to
a no-op with a notice where the package is missing, and so do the
validation panels (`log_image`), which `train/validation.py` also writes
as PNG files.  The JAX package's TensorBoard sink
(`flax.metrics.tensorboard`) and its `jax.profiler` trace have no
counterpart: the port takes no new sink.
"""

from __future__ import annotations

import logging
import sys
import time
from typing import Dict, Optional


def create_logger(name: str = "diffcodec",
                  log_file: Optional[str] = None) -> logging.Logger:
    """A logger writing '[time] name LEVEL: message' lines to stderr (and
    `log_file`); made once per name."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "[%(asctime)s] %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Windowed running average (`cmp/utils/common_utils.py:38-60`)."""

    def __init__(self, window: int = 0):
        self.window = window
        self.reset()

    def reset(self):
        self.vals = []
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        if self.window > 0:
            self.vals.append(val)
            self.vals = self.vals[-self.window:]

    @property
    def avg(self) -> float:
        if self.window > 0 and self.vals:
            return sum(self.vals) / len(self.vals)
        return self.sum / max(self.count, 1)


class StepTimer:
    """Per-step wall-clock timing with an exponential moving average.  The
    card runs asynchronously: a step's time is the host's, which a step
    that reads its loss (`.item()`) synchronises."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else \
            self.alpha * dt + (1 - self.alpha) * self.ema

    @property
    def steps_per_sec(self) -> float:
        return 1.0 / self.ema if self.ema else 0.0


class MetricsLogger:
    """Scalar metrics sink: one stdout line per call, and wandb where
    `wandb_project` is given and the package imports (else a no-op with a
    logged notice, the reference's optional `--report_to wandb`).
    `log_dir` is where wandb writes; no TensorBoard file is made."""

    def __init__(self, log_dir: Optional[str] = None,
                 logger: Optional[logging.Logger] = None,
                 wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None):
        self.logger = logger or create_logger()
        self.wandb = None
        if wandb_project:
            try:
                import wandb
                self.wandb = wandb.init(project=wandb_project,
                                        name=wandb_run_name, dir=log_dir)
            except Exception as e:  # package absent / offline
                self.logger.warning(
                    "wandb requested but unavailable (%s); scalars go to "
                    "stdout only", e)
                self.wandb = None

    def log(self, metrics: Dict[str, float], step: int):
        line = " ".join(f"{k}={float(v):.5g}" for k, v in metrics.items())
        self.logger.info("step %d: %s", step, line)
        if self.wandb is not None:
            self.wandb.log({k: float(v) for k, v in metrics.items()},
                           step=step)

    def log_image(self, tag: str, image, step: int):
        """An HWC uint8 image panel to wandb where it is on (the
        reference's validation image grids, train_controlnet.py:222-248);
        else nothing: the panel's PNG file is the record."""
        if self.wandb is not None:
            import wandb
            self.wandb.log({tag: wandb.Image(image)}, step=step)
