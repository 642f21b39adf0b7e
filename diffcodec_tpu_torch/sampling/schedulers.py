"""Noise schedule, the UniPC sampler with its tables on the host, and the
residual DDPM's ancestral step.

Counterpart: `diffcodec_tpu/sampling/schedulers.py` (:53-317; `ddpm_step`
:104-130).  UniPC
matches diffusers' `UniPCMultistepScheduler` defaults (solver order 2, bh2,
data prediction, lower-order final step, corrector on, 'linspace' grid).
Every per-step coefficient is computed on the host in float64 and rounded
to float32, as the JAX package's tables are; a step is a handful of
multiply-adds on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from diffcodec_tpu_torch.config import SchedulerConfig


def make_betas(cfg: SchedulerConfig) -> np.ndarray:
    T = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, T, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, T,
                           dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.asarray([min(1 - alpha_bar((i + 1) / T) / alpha_bar(i / T),
                               0.999) for i in range(T)], np.float64)
    raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class NoiseSchedule:
    """alphas_cumprod as a float32 numpy table [T]."""
    cfg: SchedulerConfig
    alphas_cumprod: np.ndarray

    @classmethod
    def create(cls, cfg: SchedulerConfig = SchedulerConfig()):
        abar = np.cumprod(1.0 - make_betas(cfg))
        return cls(cfg=cfg, alphas_cumprod=abar.astype(np.float32))

    def _coeffs(self, timesteps, ndim: int):
        """(sqrt(abar_t), sqrt(1 - abar_t)) in fp32: Python floats for one
        timestep (an int or a 0-d tensor), or for a [B] tensor of them (one
        per sample, as training draws them) two [B, 1, ..., 1] tensors of
        `ndim` dimensions on the timesteps' device."""
        if isinstance(timesteps, torch.Tensor) and timesteps.dim() > 0:
            abar = torch.from_numpy(self.alphas_cumprod).to(
                timesteps.device)[timesteps.long()]
            shape = (-1,) + (1,) * (ndim - 1)
            return (torch.sqrt(abar).reshape(shape),
                    torch.sqrt(1.0 - abar).reshape(shape))
        abar = self.alphas_cumprod[int(timesteps)]
        return (float(np.sqrt(abar)),
                float(np.sqrt(np.float32(1.0) - abar)))

    def add_noise(self, sample: torch.Tensor, noise: torch.Tensor,
                  timesteps) -> torch.Tensor:
        """q(x_t | x_0): sqrt(abar_t) x0 + sqrt(1 - abar_t) eps, fp32;
        timesteps: an int or a [B] tensor (see `_coeffs`)."""
        sa, so = self._coeffs(timesteps, sample.dim())
        return sa * sample.float() + so * noise.float()

    def velocity(self, sample: torch.Tensor, noise: torch.Tensor,
                 timesteps) -> torch.Tensor:
        """v-prediction target: sqrt(abar_t) eps - sqrt(1 - abar_t) x0,
        fp32."""
        sa, so = self._coeffs(timesteps, sample.dim())
        return sa * noise.float() - so * sample.float()

    def pred_original_sample(self, sample: torch.Tensor,
                             model_output: torch.Tensor,
                             timesteps) -> torch.Tensor:
        """x0 from (x_t, model output, t), in fp32."""
        sa, so = self._coeffs(timesteps, sample.dim())
        sample = sample.float()
        model_output = model_output.float()
        if self.cfg.prediction_type == "epsilon":
            return (sample - so * model_output) / sa
        if self.cfg.prediction_type == "v_prediction":
            return sa * sample - so * model_output
        raise ValueError(self.cfg.prediction_type)


def ddpm_step(schedule: NoiseSchedule, model_output: torch.Tensor,
              timestep: int, prev_timestep: int, sample: torch.Tensor,
              noise: torch.Tensor = None,
              clip_sample: bool = True) -> torch.Tensor:
    """One ancestral DDPM step x_t -> x_{t-1} (epsilon parameterisation),
    fp32.  prev_timestep < 0 is the final step, which adds no noise
    (`noise` may then be None).  The coefficients are the JAX package's
    float32 arithmetic, computed on the host in its order."""
    f32 = np.float32
    table = schedule.alphas_cumprod
    abar_t = table[int(timestep)]
    final = int(prev_timestep) < 0
    abar_prev = f32(1.0) if final else table[int(prev_timestep)]
    alpha_t = abar_t / abar_prev
    beta_t = f32(1.0) - alpha_t
    x0 = schedule.pred_original_sample(sample, model_output, int(timestep))
    if clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    one_m_abar_t = f32(1.0) - abar_t
    one_m_abar_prev = f32(1.0) - abar_prev
    coef_x0 = np.sqrt(abar_prev) * beta_t / one_m_abar_t
    coef_xt = np.sqrt(alpha_t) * one_m_abar_prev / one_m_abar_t
    mean = float(coef_x0) * x0 + float(coef_xt) * sample.float()
    if final:
        return mean
    var = beta_t * one_m_abar_prev / one_m_abar_t
    sigma = np.sqrt(max(var, f32(1e-20)))
    return mean + float(sigma) * noise.float()


def unipc_timesteps(num_train_timesteps: int,
                    num_inference_steps: int) -> np.ndarray:
    """diffusers 'linspace' timestep grid, descending [N]."""
    steps = np.linspace(0, num_train_timesteps - 1,
                        num_inference_steps + 1).round()[::-1][:-1]
    return steps.astype(np.int64)


class UniPCTables(NamedTuple):
    """Per-step coefficients, each [N] float32 numpy (computed in float64).
    Index i is the step x(t_i) -> x(t_{i+1})."""
    timesteps: np.ndarray   # [N] int64, descending
    p_cx: np.ndarray        # predictor: sigma_{i+1} / sigma_i
    p_cm0: np.ndarray       # -alpha_{i+1} * expm1(-h_i)
    p_cd1: np.ndarray       # -alpha_{i+1} * B(h_i) * rho_p (0 at order 1)
    p_invr: np.ndarray      # 1 / r_i
    c_on: np.ndarray        # 1 where the corrector applies at step i
    c_cx: np.ndarray        # corrector: sigma_i / sigma_{i-1}
    c_cm0: np.ndarray       # -alpha_i * expm1(-h_{i-1})
    c_cd1t: np.ndarray      # -alpha_i * B(h_{i-1}) * rho_t
    c_cd1h: np.ndarray      # -alpha_i * B(h_{i-1}) * rho_hist
    c_invr: np.ndarray      # 1 / r of the corrector's history term


class UniPCState(NamedTuple):
    sample: torch.Tensor       # x at t_i (uncorrected prediction)
    last_sample: torch.Tensor  # x at t_{i-1} (after the corrector)
    m_prev: torch.Tensor       # x0 prediction at t_{i-1}
    m_prev2: torch.Tensor      # x0 prediction at t_{i-2}


@dataclasses.dataclass(frozen=True, eq=False)
class UniPC:
    """UniPC (order 2, bh2, x0 prediction).

        tables = unipc.tables(); state = unipc.init_state(latents)
        for i: eps = model(state.sample, tables.timesteps[i])
               state = unipc.step(tables, state, eps, i)
        final latents = state.sample
    """
    schedule: NoiseSchedule
    num_inference_steps: int

    def tables(self) -> UniPCTables:
        N = self.num_inference_steps
        ts = unipc_timesteps(self.schedule.cfg.num_train_timesteps, N)
        abar = np.asarray(self.schedule.alphas_cumprod, np.float64)
        alpha = np.sqrt(abar[ts])
        sigma = np.sqrt(1.0 - abar[ts])
        lam = np.log(alpha) - np.log(sigma)
        t = {k: np.zeros(N) for k in UniPCTables._fields[1:]}
        # effective predictor order (diffusers: min(order, N - i, i + 1))
        p_order = [min(2, N - i, i + 1) for i in range(N)]
        for i in range(N):
            h = lam[i + 1] - lam[i] if i + 1 < N else np.inf
            if i + 1 < N:
                t["p_cx"][i] = sigma[i + 1] / sigma[i]
                t["p_cm0"][i] = -alpha[i + 1] * np.expm1(-h)
            else:
                t["p_cx"][i] = 0.0   # sigma_final = 0
                t["p_cm0"][i] = 1.0  # x -> x0
            if p_order[i] >= 2 and np.isfinite(h):
                r = (lam[i - 1] - lam[i]) / h
                t["p_invr"][i] = 1.0 / r
                t["p_cd1"][i] = -alpha[i + 1] * np.expm1(-h) * 0.5
            if i >= 1:
                # corrector of x(t_i), built on the step t_{i-1} -> t_i
                hc = lam[i] - lam[i - 1]
                B_h = np.expm1(-hc)
                t["c_on"][i] = 1.0
                t["c_cx"][i] = sigma[i] / sigma[i - 1]
                t["c_cm0"][i] = -alpha[i] * np.expm1(-hc)
                if p_order[i - 1] >= 2:
                    r = (lam[i - 2] - lam[i - 1]) / hc
                    t["c_invr"][i] = 1.0 / r
                    hh = -hc
                    h_phi_1 = np.expm1(hh)
                    h_phi_2 = h_phi_1 / hh - 1.0
                    h_phi_3 = h_phi_2 / hh - 0.5
                    b1 = h_phi_2 / B_h
                    b2 = 2.0 * h_phi_3 / B_h
                    # [[1, 1], [r, 1]] @ [rho_h, rho_t] = [b1, b2]
                    rho_h = (b2 - b1) / (r - 1.0)
                    rho_t = b1 - rho_h
                else:
                    rho_h, rho_t = 0.0, 0.5
                t["c_cd1t"][i] = -alpha[i] * B_h * rho_t
                t["c_cd1h"][i] = -alpha[i] * B_h * rho_h
        return UniPCTables(timesteps=ts, **{k: v.astype(np.float32)
                                            for k, v in t.items()})

    def init_state(self, latents: torch.Tensor) -> UniPCState:
        z = torch.zeros_like(latents, dtype=torch.float32)
        return UniPCState(sample=latents.float(), last_sample=z, m_prev=z,
                          m_prev2=z)

    def step(self, tables: UniPCTables, state: UniPCState,
             model_output: torch.Tensor, i: int) -> UniPCState:
        """Corrector on x(t_i), then predictor to t_{i+1}."""
        f = lambda name: float(getattr(tables, name)[i])  # noqa: E731
        m_t = self.schedule.pred_original_sample(
            state.sample, model_output, tables.timesteps[i])
        if f("c_on") > 0:
            d1_t = m_t - state.m_prev
            d1_h = (state.m_prev2 - state.m_prev) * f("c_invr")
            x = (f("c_cx") * state.last_sample + f("c_cm0") * state.m_prev
                 + f("c_cd1t") * d1_t + f("c_cd1h") * d1_h)
        else:
            x = state.sample
        d1 = (state.m_prev - m_t) * f("p_invr")
        x_next = f("p_cx") * x + f("p_cm0") * m_t + f("p_cd1") * d1
        return UniPCState(sample=x_next, last_sample=x, m_prev=m_t,
                          m_prev2=state.m_prev)


def cfg_combine(noise_uncond, noise_text, guidance_scale: float):
    """Classifier-free guidance."""
    return noise_uncond + guidance_scale * (noise_text - noise_uncond)


def controlnet_keep_schedule(num_steps: int, start: float,
                             end: float) -> np.ndarray:
    """Per-step ControlNet keep flags (1 inside [start, end])."""
    return np.asarray([1.0 - float(i / num_steps < start or
                                   (i + 1) / num_steps > end)
                       for i in range(num_steps)], np.float32)
