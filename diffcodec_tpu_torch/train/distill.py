"""The consistency parameterization and teacher grid of the decoder's step
distillation, which the K-step decode (`sampling/distilled.py`) needs.

Counterpart: `diffcodec_tpu/train/distill.py` (`boundary_scalings` :60-72,
`ddim_grid` :75-82).  The distillation trainer itself is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from diffcodec_tpu_torch.sampling.schedulers import NoiseSchedule


def boundary_scalings(timesteps, sigma_data: float = 0.5,
                      timestep_scaling: float = 10.0):
    """(c_skip, c_out), fp32 tensors shaped like `timesteps`, for the
    boundary-conditioned consistency function
    f(x_t, t) = c_skip(t) x_t + c_out(t) x0(x_t, t).

    Raw train-schedule timesteps map to a karras-like sigma axis (LCM's
    choice: sigma_data 0.5, t / 1000 * 10); c_skip(0) = 1, c_out(0) = 0."""
    s = torch.as_tensor(timesteps).float() * (timestep_scaling / 1000.0)
    c_skip = sigma_data ** 2 / (s ** 2 + sigma_data ** 2)
    c_out = s / torch.sqrt(s ** 2 + sigma_data ** 2)
    return c_skip, c_out


def ddim_grid(schedule: NoiseSchedule, num_teacher_steps: int) -> np.ndarray:
    """Descending teacher timestep grid [n], int64, in equal strides
    shifted so that it starts at T - 1."""
    T = schedule.cfg.num_train_timesteps
    stride = T // num_teacher_steps
    ts = np.arange(num_teacher_steps - 1, -1, -1, dtype=np.int64) * stride
    return ts + (T - 1 - ts[0])
