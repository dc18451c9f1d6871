"""All-k factorized triplet pool: CUDA kernel wrapper + plain version.

Counterpart of `phoregen_tpu/ops/pallas_triplet.py` (the file keeps the
name so the two are found side by side). For each graph and target bond
(j, i):

    angle(k, i) at i between j->i and k->i          (from positions)
    pre(k, i)   = act(LN(a_kj[k, j] + a_ji[j, i] + enc(angle) @ w_ang))
    score(k, h) = <pre(k, i), q(j, i, h)> / sqrt(Wt)
    alpha       = masked softmax over k (floor 1e-30: a fully masked
                  column pools to exactly 0)
    pooled(h)   = sum_k alpha * pre(k, i)            -> [N, N, heads*Wt]

`triplet_pool_plain` computes it on materialised [B,k,j,i,*] grids (the
counterpart of `triplet_pool_xla`); `triplet_pool_cuda` launches the
hand-written kernel of `csrc/triplet_pool.cu`, in which nothing
O(N^3)-sized reaches device memory. The wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes
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
# the kernel's activation codes (csrc/triplet_pool.cu, enum ACT_*)
ACT_CODES = {name: i for i, name in enumerate(ACTS)}

LAUNCHES = {"triplet_pool": 0}
# the tensors the kernel reads or writes 16 bytes at a time
_LOAD16 = frozenset({"a_kj", "a_ji", "q", "out"})


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _ptr(tensor, name, shape):
    if not tensor.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if tensor.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {tensor.dtype}")
    if tuple(tensor.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(tensor.shape)}, expected "
                         f"{shape}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if name in _LOAD16 and tensor.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte aligned storage (the "
                         f"kernel moves it 16 bytes at a time)")
    return tensor.data_ptr()


# the most heads one launch takes (a lane per head in the kernel's
# softmax); more are split into groups, one launch each
MAX_HEADS = 32


def _pad_last(t, width: int):
    """`t` with its last axis zero-padded to `width` (a new contiguous
    tensor), or `t` itself where it is that wide already."""
    pad = width - t.shape[-1]
    return F.pad(t, (0, pad)).contiguous() if pad else t


def triplet_pool_cuda(a_kj, a_ji, q, pos, mask, w_ang, ln_scale, ln_bias,
                      act: str, norm: bool, num_ang_funcs: int = 3):
    """Same signature and result as `triplet_pool_plain`; CUDA kernel for
    CUDA tensors, plain version on the CPU. No gradient flows through the
    kernel (see `triplet_pool`). The kernel takes feature rows of a
    multiple of 4: a Wt that is none is zero-padded here (the kernel takes
    the LayerNorm and the score scale over the true Wt) and the padding
    cut from the result; more than MAX_HEADS heads go in groups of at most
    MAX_HEADS, one launch each."""
    if not a_kj.is_cuda:
        return triplet_pool_plain(a_kj, a_ji, q, pos, mask, w_ang, ln_scale,
                                  ln_bias, act, norm, num_ang_funcs)
    from . import _build
    B, N, _, Wt = a_kj.shape
    heads = q.shape[-2]
    enc = 1 + 4 * num_ang_funcs
    if act not in ACT_CODES:
        raise NotImplementedError(f"activation {act!r} is not built into "
                                  f"the triplet-pool kernel")
    if Wt > 32:
        raise ValueError(f"the triplet-pool kernel takes Wt up to 32 (got "
                         f"Wt={Wt})")
    for name, t, shape in (("a_ji", a_ji, (B, N, N, Wt)),
                           ("q", q, (B, N, N, heads, Wt)),
                           ("w_ang", w_ang, (enc, Wt)),
                           ("ln_scale", ln_scale, (Wt,)),
                           ("ln_bias", ln_bias, (Wt,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    Wp = (Wt + 3) // 4 * 4
    a_kj, a_ji, w_ang, ln_scale, ln_bias = (
        _pad_last(t, Wp) for t in (a_kj, a_ji, w_ang, ln_scale, ln_bias))
    maskf = mask.to(torch.float32).contiguous()
    lib = _build.load("triplet_pool")
    ngroups = -(-heads // MAX_HEADS)
    bounds = [heads * g // ngroups for g in range(ngroups + 1)]
    outs = []
    for h0, h1 in zip(bounds[:-1], bounds[1:]):
        hg = h1 - h0
        qg = _pad_last(q if ngroups == 1 else
                       q[..., h0:h1, :].contiguous(), Wp)
        out = torch.empty(B, N, N, hg * Wp, device=a_kj.device,
                          dtype=torch.float32)
        named = (("a_kj", a_kj, (B, N, N, Wp)), ("a_ji", a_ji, (B, N, N, Wp)),
                 ("q", qg, (B, N, N, hg, Wp)), ("pos", pos, (B, N, 3)),
                 ("mask", maskf, (B, N)), ("w_ang", w_ang, (enc, Wp)),
                 ("ln_scale", ln_scale, (Wp,)), ("ln_bias", ln_bias, (Wp,)),
                 ("out", out, (B, N, N, hg * Wp)))
        ptrs = [_ptr(t, name, shape) for name, t, shape in named]
        arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
        dims = (ctypes.c_int * 7)(B, N, hg, Wt, num_ang_funcs, int(norm),
                                  ACT_CODES[act])
        rc = lib.tp_triplet_pool(arr, len(ptrs), dims,
                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tp_triplet_pool: CUDA error {rc}")
        LAUNCHES["triplet_pool"] += 1
        outs.append(out if Wp == Wt else
                    out.view(B, N, N, hg, Wp)[..., :Wt].reshape(
                        B, N, N, hg * Wt))
    return outs[0] if ngroups == 1 else torch.cat(outs, -1)


class _TripletPoolFn(torch.autograd.Function):
    """Kernel forward; backward by recomputing through the plain version
    from the O(N^2) inputs. `mask` gets no gradient."""

    @staticmethod
    def forward(ctx, a_kj, a_ji, q, pos, mask, w_ang, ln_scale, ln_bias,
                act, norm, num_ang_funcs):
        ctx.save_for_backward(a_kj, a_ji, q, pos, mask, w_ang, ln_scale,
                              ln_bias)
        ctx.static = (act, norm, num_ang_funcs)
        return triplet_pool_cuda(a_kj, a_ji, q, pos, mask, w_ang, ln_scale,
                                 ln_bias, act, norm, num_ang_funcs)

    @staticmethod
    def backward(ctx, g):
        a_kj, a_ji, q, pos, mask, w_ang, ln_scale, ln_bias = ctx.saved_tensors
        ins = [t.detach().requires_grad_(True)
               for t in (a_kj, a_ji, q, pos, w_ang, ln_scale, ln_bias)]
        with torch.enable_grad():
            out = triplet_pool_plain(*ins[:4], mask, *ins[4:], *ctx.static)
        # norm=False leaves ln_scale / ln_bias out of the graph
        d = torch.autograd.grad(out, ins, g, allow_unused=True)
        return (*d[:4], None, *d[4:], None, None, None)


def triplet_pool(a_kj, a_ji, q, pos, mask, w_ang, ln_scale, ln_bias,
                 act: str, norm: bool, num_ang_funcs: int = 3,
                 use_pallas: bool = False):
    """Dispatch: with `use_pallas` the kernel (backward through the plain
    version), otherwise the plain version. With `use_pallas` and CUDA
    tensors there is no path to the plain forward."""
    if not use_pallas:
        return triplet_pool_plain(a_kj, a_ji, q, pos, mask, w_ang, ln_scale,
                                  ln_bias, act, norm, num_ang_funcs)
    return _TripletPoolFn.apply(a_kj, a_ji, q, pos, mask, w_ang, ln_scale,
                                ln_bias, act, norm, num_ang_funcs)
