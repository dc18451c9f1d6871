"""Radial/temporal/angular basis encodings (pure functions of tensors).

Counterpart of `phoregen_tpu/ops/rbf.py`: `GaussianSmearing` with the fixed
non-uniform 20-point offset grid or a uniform grid, the linear time grid
embedding, and the sin/cos angular encoding.

The encodings take their tables (offsets, frequency bands) as numpy
arrays or tensors. A numpy table is copied to the device once a (table,
device, dtype) and kept (`_table`): a copy from host memory makes the host
wait until the device has run everything queued before it, so a copy in
every call held the sampling loop in step with the device, layer by
layer.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import FIXED_RBF_OFFSETS

# (table bytes, numpy dtype, shape, device, dtype) -> the table there
_TABLES = {}


def _table(table, device, dtype) -> torch.Tensor:
    """`table` as a tensor on `device` in `dtype`; a numpy table's copy is
    made once and kept."""
    if isinstance(table, torch.Tensor):
        return table.to(device=device, dtype=dtype)
    a = np.asarray(table)
    key = (a.tobytes(), a.dtype.str, a.shape, torch.device(device), dtype)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


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
    offset = _table(offset, dist.device, dist.dtype)
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
    offset = _table(offset, t.device, torch.float32)
    coeff = _table(coeff, t.device, torch.float32)
    d = t[..., None] - offset
    return torch.exp(coeff * d * d)


def angular_encoding_freq_bands(num_funcs: int = 3) -> np.ndarray:
    return np.asarray([i + 1 for i in range(num_funcs)]
                      + [1.0 / (i + 1) for i in range(num_funcs)],
                      dtype=np.float32)


def angular_encoding(x: torch.Tensor, freq_bands) -> torch.Tensor:
    """x [...] -> [..., 1 + 4*num_funcs] = [x, sin(x*f), cos(x*f)]."""
    f = _table(freq_bands, x.device, x.dtype)
    xe = x[..., None]
    return torch.cat([xe, torch.sin(xe * f), torch.cos(xe * f)], dim=-1)


def angular_encoding_dim(num_funcs: int = 3) -> int:
    return 1 + 2 * 2 * num_funcs
