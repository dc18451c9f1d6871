"""Beta schedules for the three asynchronous diffusion processes.

All eight schedule families of the reference are provided
(reference `models/common.py:444-544`): quad / linear / const / jsd / sigmoid /
cosine / advance / segment. These run on the host in float64 at model-build
time; the resulting coefficient tables are baked into the jitted computation
as float32 constants.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np


def _sigmoid(x):
    return 1.0 / (np.exp(-x) + 1.0)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    steps = timesteps + 1
    x = np.linspace(0, steps, steps)
    alphas_cumprod = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def advance_schedule(timesteps: int, scale_start: float, scale_end: float,
                     width: float, return_alphas_bar: bool = False):
    """Sigmoid-shaped cumulative-alpha schedule from scale_start to scale_end."""
    k = width
    A0, A1 = scale_end, scale_start
    a = (A0 - A1) / (_sigmoid(-k) - _sigmoid(k))
    b = 0.5 * (A0 + A1 - a)
    x = np.linspace(-1, 1, timesteps)
    alphas_cumprod = a * _sigmoid(-k * x) + b

    alphas = np.zeros_like(alphas_cumprod)
    alphas[0] = alphas_cumprod[0]
    alphas[1:] = alphas_cumprod[1:] / alphas_cumprod[:-1]
    betas = np.clip(1 - alphas, 0, 1)
    if return_alphas_bar:
        return betas, alphas_cumprod
    return betas


def segment_schedule(timesteps: int, time_segment: Sequence[int],
                     segment_diff: Sequence[Dict[str, Any]]) -> np.ndarray:
    """Piecewise advance schedule; used for the 'asynchronous' bond noising."""
    assert int(np.sum(time_segment)) == timesteps, (
        f"segments {time_segment} must sum to {timesteps}")
    alphas_cumprod: List[float] = []
    for seg_len, params in zip(time_segment, segment_diff):
        _, alphas_this = advance_schedule(seg_len + 1, return_alphas_bar=True,
                                          **params)
        alphas_cumprod.extend(alphas_this[1:])
    alphas_cumprod = np.asarray(alphas_cumprod)

    alphas = np.zeros_like(alphas_cumprod)
    alphas[0] = alphas_cumprod[0]
    alphas[1:] = alphas_cumprod[1:] / alphas_cumprod[:-1]
    return np.clip(1 - alphas, 0, 1)


def get_beta_schedule(beta_schedule: str, num_timesteps: int, **kwargs) -> np.ndarray:
    if beta_schedule == "quad":
        betas = np.linspace(kwargs["beta_start"] ** 0.5,
                            kwargs["beta_end"] ** 0.5,
                            num_timesteps, dtype=np.float64) ** 2
    elif beta_schedule == "linear":
        betas = np.linspace(kwargs["beta_start"], kwargs["beta_end"],
                            num_timesteps, dtype=np.float64)
    elif beta_schedule == "const":
        betas = kwargs["beta_end"] * np.ones(num_timesteps, dtype=np.float64)
    elif beta_schedule == "jsd":  # 1/T, 1/(T-1), ..., 1
        betas = 1.0 / np.linspace(num_timesteps, 1, num_timesteps,
                                  dtype=np.float64)
    elif beta_schedule == "sigmoid":
        s = kwargs.get("s", 6)
        betas = np.linspace(-s, s, num_timesteps)
        betas = _sigmoid(betas) * (kwargs["beta_end"] - kwargs["beta_start"]) \
            + kwargs["beta_start"]
    elif beta_schedule == "cosine":
        betas = cosine_beta_schedule(num_timesteps, s=kwargs.get("s", 0.008))
    elif beta_schedule == "advance":
        betas = advance_schedule(num_timesteps,
                                 kwargs.get("scale_start", 0.999),
                                 kwargs.get("scale_end", 0.001),
                                 kwargs.get("width", 2))
    elif beta_schedule == "segment":
        betas = segment_schedule(num_timesteps, kwargs["time_segment"],
                                 kwargs["segment_diff"])
    else:
        raise NotImplementedError(beta_schedule)
    assert betas.shape == (num_timesteps,)
    return betas
