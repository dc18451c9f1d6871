"""Radial/temporal/angular basis encodings (pure functions of tensors).

Counterpart of `phoregen_tpu/ops/rbf.py`: `GaussianSmearing` with the fixed
non-uniform 20-point offset grid or a uniform grid, the linear time grid
embedding, and the sin/cos angular encoding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FIXED_RBF_OFFSETS


def gaussian_smearing_offsets(start: float = 0.0, stop: float = 5.0,
                              num_gaussians: int = 50, fix_offset: bool = True):
    """Return (offsets, coeff) for the RBF; coeff = -0.5 / (off1-off0)^2."""
    if fix_offset:
        offset = np.asarray(FIXED_RBF_OFFSETS, dtype=np.float32)
    else:
        offset = np.linspace(start, stop, num_gaussians, dtype=np.float32)
    coeff = -0.5 / float(offset[1] - offset[0]) ** 2
    return offset, coeff


def gaussian_smearing(dist: torch.Tensor, offset, coeff: float) -> torch.Tensor:
    """exp(coeff * (d - mu_k)^2) over a trailing offset axis: [...] -> [..., G]."""
    offset = torch.as_tensor(offset, dtype=dist.dtype, device=dist.device)
    d = dist[..., None] - offset
    return torch.exp(coeff * d * d)


def time_smearing_offsets(start: float = 0.0, stop: float = 10.0,
                          num_gaussians: int = 50, type_: str = "linear"):
    """Return (offsets, coeffs[num_gaussians]) for the time embedding."""
    if type_ == "exp":
        offset = np.exp(np.linspace(np.log(start + 1), np.log(stop + 1),
                                    num_gaussians)) - 1
    elif type_ == "linear":
        offset = np.linspace(start, stop, num_gaussians)
    else:
        raise NotImplementedError("type_ must be either exp or linear")
    diff = np.diff(offset)
    diff = np.concatenate([diff[:1], diff])
    coeff = -0.5 / (diff ** 2)
    return offset.astype(np.float32), coeff.astype(np.float32)


def time_smearing(t: torch.Tensor, offset, coeff, start: float,
                  stop: float) -> torch.Tensor:
    """Clamped Gaussian grid time embedding: t [...] -> [..., G]."""
    t = torch.clamp(t.to(torch.float32), start, stop)
    offset = torch.as_tensor(offset, dtype=torch.float32, device=t.device)
    coeff = torch.as_tensor(coeff, dtype=torch.float32, device=t.device)
    d = t[..., None] - offset
    return torch.exp(coeff * d * d)


def angular_encoding_freq_bands(num_funcs: int = 3) -> np.ndarray:
    return np.asarray([i + 1 for i in range(num_funcs)]
                      + [1.0 / (i + 1) for i in range(num_funcs)],
                      dtype=np.float32)


def angular_encoding(x: torch.Tensor, freq_bands) -> torch.Tensor:
    """x [...] -> [..., 1 + 4*num_funcs] = [x, sin(x*f), cos(x*f)]."""
    f = torch.as_tensor(freq_bands, dtype=x.dtype, device=x.device)
    xe = x[..., None]
    return torch.cat([xe, torch.sin(xe * f), torch.cos(xe * f)], dim=-1)
