"""Dense triplet bond update: the CUDA kernel of `csrc/dense_triplet.cu`.

The kernel takes the per-bond and per-atom terms of PhoreGen's published
bond update (`models/layers.py::BondUpdateTriplet`, `triplet_mode: dense`)
from the layer's prologue and does the rest: per real triplet the angle,
its encoding and projection, the three-term sums, LayerNorm and activation
of the key and value rows, a score a head against the query folded with
the key output, the softmax over the sources and the weighted sum of the
value rows; per bond the value output. Its plain version is the layer's
`_dense`, which the layer runs for every call the kernel does not take.
`LAUNCHES` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from .pallas_triplet import ACT_CODES

H, HEADS, NUM_ANG = 128, 16, 3
ENC = 1 + 4 * NUM_ANG

LAUNCHES = {"dense_triplet": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _rows(t, name, shape):
    """The row stride (floats) of `t`, a [*shape, 2H] or [*shape, H] tensor
    whose rows are contiguous and evenly strided over the leading axes (a
    column slice of a wider tensor, or an expanded row), 16-byte aligned."""
    if not t.is_cuda or t.dtype != torch.float32:
        raise TypeError(f"{name}: expected a float32 CUDA tensor")
    if tuple(t.shape[:-1]) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, leading axes "
                         f"expected {shape}")
    st = t.stride()
    row = st[-2]
    want = [row]
    for n in reversed(shape[1:]):
        want.insert(0, want[0] * n)
    if st[-1] != 1 or list(st[:-1]) != want:
        raise ValueError(f"{name}: strides {st} are not rows of stride "
                         f"{row} over {shape}")
    if row % 4 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    return row


def dense_triplet(kj_a, kj_b, ji, n_src, n_dst, q, pos, mask, w_ang_k,
                  w_ang_v, ln_k, ln_v, w_k_out, w_v_out, b_v_out, act: str,
                  norm: bool):
    """The bond update [B,N,N,H] (j, i) on CUDA float32 tensors: a_kj(k, j)
    = kj_a + kj_b + n_src[k] + n_dst[j] and a_ji(j, i) = ji, each [.., 2H]
    (the key branch's features, then the value branch's); q [B,N,N,H]
    (j, i), the query before the key output; pos [B,N,3]; mask [B,N];
    w_ang_* [13,H]; ln_k, ln_v (scale, bias) or None without `norm`;
    w_k_out, w_v_out [H,H]; b_v_out [H]. 0 off the bonds of two real atoms
    and on a bond with no third atom. H = 128, 16 heads, 3 angular bands."""
    from . import _build
    B, N = mask.shape
    if act not in ACT_CODES:
        raise NotImplementedError(f"activation {act!r} is not built into "
                                  f"the dense-triplet kernel")
    strides = [_rows(kj_a, "kj_a", (B, N, N)), _rows(kj_b, "kj_b", (B, N, N)),
               _rows(ji, "ji", (B, N, N)), _rows(n_src, "n_src", (B, N)),
               _rows(n_dst, "n_dst", (B, N))]
    for name, t in (("kj_a", kj_a), ("kj_b", kj_b), ("ji", ji),
                    ("n_src", n_src), ("n_dst", n_dst)):
        if t.shape[-1] != 2 * H:
            raise ValueError(f"{name}: rows of {t.shape[-1]}, expected {2 * H}")
    q = q.contiguous()
    ln_k = ln_k if norm else (b_v_out, b_v_out)
    ln_v = ln_v if norm else (b_v_out, b_v_out)
    named = (("q", q, (B, N, N, H)), ("pos", pos, (B, N, 3)),
             ("w_ang_k", w_ang_k, (ENC, H)), ("w_ang_v", w_ang_v, (ENC, H)),
             ("ln_k scale", ln_k[0], (H,)), ("ln_k bias", ln_k[1], (H,)),
             ("ln_v scale", ln_v[0], (H,)), ("ln_v bias", ln_v[1], (H,)),
             ("w_k_out", w_k_out, (H, H)), ("w_v_out", w_v_out, (H, H)),
             ("b_v_out", b_v_out, (H,)))
    for name, t, shape in named:
        if (not t.is_cuda or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous float32 CUDA "
                             f"tensor of shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if name != "pos" and t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte aligned storage")
    maskf = mask.to(torch.float32).contiguous()
    out = torch.empty(B, N, N, H, device=q.device, dtype=torch.float32)
    ptrs = [t.data_ptr() for t in (kj_a, kj_b, ji, n_src, n_dst)] + [
        t.data_ptr() for _, t, _ in named[:1]] + [pos.data_ptr(),
                                                  maskf.data_ptr()] + [
        t.data_ptr() for _, t, _ in named[2:]] + [out.data_ptr()]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dims = (ctypes.c_int * 9)(B, N, int(norm), ACT_CODES[act], *strides)
    rc = _build.load("dense_triplet").dt_dense_triplet(
        arr, len(ptrs), dims, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dt_dense_triplet: CUDA error {rc}")
    LAUNCHES["dense_triplet"] += 1
    return out
