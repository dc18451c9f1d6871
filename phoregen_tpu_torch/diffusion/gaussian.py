"""Gaussian (DDPM) transition for positions.

Counterpart of `phoregen_tpu/diffusion/gaussian.py`: the forward noising
`q(x_t | x_0)` of training, prior draws and the reverse step
`mu = coef_x0 * x_recon + coef_xt * x_t - energy_grad`, whose final (t = 0)
step returns the mean. Coefficients are built on the host in float64 and
used as float32, as in the JAX package. Every draw takes a
`torch.Generator` or the noise itself.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class GaussianTransition:
    def __init__(self, betas: np.ndarray, num_classes: Optional[int] = None,
                 scaling: float = 1.0):
        self.betas = np.asarray(betas, np.float64)
        self.num_classes = num_classes
        self.scaling = scaling
        self.alphas_bar = np.cumprod(1.0 - self.betas).astype(np.float32)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def add_noise(self, x: torch.Tensor, t: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
        """x_t ~ q(x_t | x_0) = sqrt(ab_t) x_0 + sqrt(1 - ab_t) eps.
        x: [B, ...] (continuous) or int class ids (-> scaled one-hot, then
        (x_t, x_0) is returned); t: [B]. `noise` injects eps."""
        if self.num_classes is not None:
            x = torch.nn.functional.one_hot(x.long(), self.num_classes).to(
                torch.float32)
        x = x / self.scaling
        a_bar = torch.as_tensor(self.alphas_bar, device=x.device)[t.long()]
        a_bar = a_bar.reshape(a_bar.shape + (1,) * (x.dim() - 1))
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=x.device,
                                dtype=x.dtype)
        pert = torch.sqrt(a_bar) * x + torch.sqrt(1.0 - a_bar) * noise
        return pert if self.num_classes is None else (pert, x)

    def sample_init(self, shape, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
        if self.num_classes is not None:
            shape = tuple(shape) + (self.num_classes,)
        return torch.randn(tuple(shape), generator=generator, device=device,
                           dtype=torch.float32)

    @staticmethod
    def get_prev_with(x_t: torch.Tensor, x_recon: torch.Tensor,
                      coef_x0: float, coef_xt: float, std: float,
                      is_final: bool, energy_grad=0.0,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reverse step with explicit scalar coefficients; `is_final` returns
        the mean. `noise` injects the N(0,1) draw, else `generator` gives it."""
        mu = coef_x0 * x_recon + coef_xt * x_t - energy_grad
        if is_final:
            return mu
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        return mu + std * noise


def build_gaussian_strided(betas: np.ndarray, timesteps: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step posterior coefficients (coef_x0, coef_xt, std), each [S]
    float32, for the descending timesteps ending at 0; the last entry is the
    t = 0 step (alpha-bar_prev = 1), consumed with the mean-only override."""
    betas = np.asarray(betas, np.float64)
    ab = np.cumprod(1.0 - betas)
    ts = np.asarray(timesteps, np.int64)
    assert ts[-1] == 0 and (np.diff(ts) < 0).all()
    coef_x0, coef_xt, std = [], [], []
    for i in range(len(ts)):
        t = int(ts[i])
        ab_t = ab[t]
        ab_p = ab[int(ts[i + 1])] if i + 1 < len(ts) else 1.0
        ratio = ab_t / ab_p
        coef_x0.append(np.sqrt(ab_p) * (1.0 - ratio) / (1.0 - ab_t))
        coef_xt.append(np.sqrt(ratio) * (1.0 - ab_p) / (1.0 - ab_t))
        std.append(np.sqrt((1.0 - ab_p) / (1.0 - ab_t) * (1.0 - ratio)))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(coef_x0), f32(coef_xt), f32(std)
