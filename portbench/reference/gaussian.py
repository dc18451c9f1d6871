"""Gaussian (DDPM) transition for positions, and for the one-hot-relaxed
atom and bond types of `categorical_space: continuous`.

Counterpart of `phoregen_tpu/diffusion/gaussian.py`: the forward noising
`q(x_t | x_0)` of training (of class ids: their one-hots over `scaling`),
prior draws and the reverse step
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
        alphas = 1.0 - self.betas
        ab = np.cumprod(alphas)
        ab_prev = np.concatenate([[1.0], ab[:-1]])
        self.alphas_bar = ab.astype(np.float32)
        # one-step posterior coefficients per t, [T] float32
        self.coef_x0 = (np.sqrt(ab_prev) * self.betas / (1 - ab)).astype(
            np.float32)
        self.coef_xt = (np.sqrt(alphas) * (1 - ab_prev) / (1 - ab)).astype(
            np.float32)
        self.std = np.sqrt((1 - ab_prev) * self.betas / (1 - ab)).astype(
            np.float32)

    @classmethod
    def create(cls, betas: np.ndarray, num_classes: Optional[int] = None,
               scaling: float = 1.0) -> "GaussianTransition":
        """The constructor under the JAX package's name."""
        return cls(betas, num_classes, scaling)

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
            noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        pert = torch.sqrt(a_bar) * x + torch.sqrt(1.0 - a_bar) * noise
        return pert if self.num_classes is None else (pert, x)

    def get_prev_from_recon(self, x_t: torch.Tensor, x_recon: torch.Tensor,
                            t: torch.Tensor, energy_grad=0.0,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """One reverse step x_{t-1} ~ q(x_{t-1} | x_t, x_0 = x_recon) with
        per-graph t [B] (the one-step coefficients); `energy_grad` is
        subtracted from the mean, and graphs at t == 0 get the mean."""
        def coef(table):
            c = torch.as_tensor(table, device=x_t.device)[t.long()]
            return c.reshape(c.shape + (1,) * (x_t.dim() - 1))
        mu = coef(self.coef_x0) * x_recon + coef(self.coef_xt) * x_t \
            - energy_grad
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
        time_zero = (t == 0).reshape(t.shape + (1,) * (x_t.dim() - 1))
        return torch.where(time_zero, mu, mu + coef(self.std) * noise)

    def sample_init(self, shape, generator: Optional[torch.Generator],
                    device) -> torch.Tensor:
        if self.num_classes is not None:
            shape = tuple(shape) + (self.num_classes,)
        return torch.randn(shape, generator=generator, device=device)

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
            noise = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
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
