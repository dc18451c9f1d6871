"""The triplet pool over all sources k, plain PyTorch (frozen copy of the
plain version in `phoregen_tpu_torch/ops/pallas_triplet.py`, without its
CUDA kernel). For each graph and target bond (j, i):

    angle(k, i) at i between j->i and k->i          (from positions)
    pre(k, i)   = act(LN(a_kj[k, j] + a_ji[j, i] + enc(angle) @ w_ang))
    score(k, h) = <pre(k, i), q(j, i, h)> / sqrt(Wt)
    alpha       = masked softmax over k (floor 1e-30)
    pooled(h)   = sum_k alpha * pre(k, i)            -> [N, N, heads*Wt]
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
from torch.nn import functional as F

from .rbf import angular_encoding, angular_encoding_freq_bands

LN_EPS = 1e-6
NEG_INF = -1e9
# lower clamp for |j-i x k-i|^2 before the sqrt: at degenerate triplets
# (k == i, or exactly collinear atoms) it is exactly 0, where d(sqrt) is
# infinite and d(atan2) at (0, 0) is NaN; the clamp keeps every gradient
# finite, and the mask then zeroes those lanes.
CROSS_SQ_EPS = 1e-12
# this op's softmax denominator floor (ops/masked.py uses 1.0)
DENOM_FLOOR = 1e-30

# activations by name, as `phoregen_tpu/models/layers.py::ACTS` lists them;
# gelu is the tanh approximation (jax.nn.gelu's default)
ACTS: Dict[str, Callable] = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01), "elu": F.elu,
    "selu": F.selu, "softplus": F.softplus, "identity": lambda x: x,
}



def triplet_angle(rel_j, rel_k):
    """Angle between two broadcastable [..., 3] vectors via
    atan2(sqrt(max(|a|^2 |b|^2 - (a.b)^2, CROSS_SQ_EPS)), a.b)."""
    dot = (rel_j * rel_k).sum(-1)
    njsq = (rel_j * rel_j).sum(-1)
    nksq = (rel_k * rel_k).sum(-1)
    cross = torch.sqrt(torch.clamp(njsq * nksq - dot * dot,
                                   min=CROSS_SQ_EPS))
    return torch.atan2(cross, dot)


def pre_activate(pre, ln_scale, ln_bias, act: str, norm: bool):
    """LayerNorm in the E[(x - mu)^2] form, then the activation."""
    if norm:
        mu = pre.mean(-1, keepdim=True)
        var = ((pre - mu) ** 2).mean(-1, keepdim=True)
        pre = (pre - mu) * torch.rsqrt(var + LN_EPS) * ln_scale + ln_bias
    return ACTS[act](pre)


def triplet_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B,N] -> [B,k,j,i] bool: k, j, i valid and pairwise different."""
    m = mask.to(torch.bool)
    N = m.shape[1]
    valid = (m[:, :, None, None] & m[:, None, :, None]
             & m[:, None, None, :])
    idx = torch.arange(N, device=m.device)
    neq = ((idx[:, None, None] != idx[None, :, None])
           & (idx[None, :, None] != idx[None, None, :])
           & (idx[:, None, None] != idx[None, None, :]))
    return valid & neq[None]


def triplet_pool_plain(a_kj, a_ji, q, pos, mask, w_ang, ln_scale, ln_bias,
                       act: str, norm: bool, num_ang_funcs: int = 3):
    """Materialised [B,k,j,i,*] version.

    a_kj [B,N,N,Wt] (k, j); a_ji [B,N,N,Wt] (j, i); q [B,N,N,heads,Wt]
    (j, i); pos [B,N,3]; mask [B,N] bool. Returns pooled
    [B,N,N,heads*Wt] indexed (j, i)."""
    B, N, _, Wt = a_kj.shape
    heads = q.shape[-2]
    rel = pos[:, :, None, :] - pos[:, None, :, :]            # rel[x,i] = x - i
    angle = triplet_angle(rel[:, :, None], rel[:, None])     # [B,j,k,i]
    a_ang = angular_encoding(
        angle, angular_encoding_freq_bands(num_ang_funcs)) @ w_ang
    pre = (a_kj[:, :, :, None, :] + a_ji[:, None, :, :, :]
           + a_ang.transpose(1, 2))                          # [B,k,j,i,Wt]
    pre = pre_activate(pre, ln_scale, ln_bias, act, norm)
    scores = torch.einsum("bkjiw,bjihw->bkjih", pre, q) / float(np.sqrt(Wt))
    tri = triplet_mask(mask)[..., None]
    scores = torch.where(tri, scores, torch.full_like(scores, NEG_INF))
    smax = scores.amax(dim=1, keepdim=True).detach()
    e = torch.exp(scores - smax) * tri.to(scores.dtype)
    alpha = e / torch.clamp(e.sum(dim=1, keepdim=True), min=DENOM_FLOOR)
    pooled = torch.einsum("bkjih,bkjiw->bjihw", alpha, pre)
    return pooled.reshape(B, N, N, heads * Wt)


def triplet_pool(a_kj, a_ji, q, pos, mask, w_ang, ln_scale, ln_bias,
                 act: str, norm: bool, num_ang_funcs: int = 3,
                 use_pallas: bool = False):
    """The plain pool (`use_pallas` is accepted and ignored: the reference
    has no kernel)."""
    del use_pallas
    return triplet_pool_plain(a_kj, a_ji, q, pos, mask, w_ang, ln_scale,
                              ln_bias, act, norm, num_ang_funcs)
