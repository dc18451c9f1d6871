"""PhoreGen's published bond update (`models/uni_denoiser.py`,
`BondUpdateLayer`) in plain float32 torch, in the upstream project's own
form: graph by graph, over the explicit list of directed triplets, with no
padding and no [N, N, N] grid. It shares nothing with the padded-grid form
of `reference/layers.py::BondUpdateTriplet._dense` or of the program but
the parameter tree it reads (the flax names of the JAX package) and the
radial and angular encodings of `reference/rbf.py`.

For each graph, over its real atoms only:

    triplets   every (k, j, i) of three distinct atoms: the directed bond
               k -> j feeding the target bond j -> i (upstream `triplets()`
               on the fully connected ligand graph)
    f_kj       [h_bond(k, j), rbf(|x_k - x_j|), h(k), h(j)] gathered per
               triplet (the node states only with `include_h_node`)
    angle      at i, between x_j - x_i and x_k - x_i
    pre        f_kj W_kj + b_kj + rbf(|x_j - x_i|) W_ji + enc(angle) W_ang,
               one such sum for the keys (hk_*) and one for the values
               (hv_*), each at the full hidden width H
    k, v       act(LayerNorm(pre)) W_out + b_out, per triplet
    q          MLP([h_bond(j, i), h(i)]) per target bond
    alpha      softmax over the triplets of each target bond (j, i), per
               head, score q . k / sqrt(H / heads): a segment softmax
               (scatter max, exp, index_add)
    out(j, i)  sum of alpha v over the bond's triplets (index_add)

Departures from upstream, each following the JAX package's definition:

- the angle is atan2(sqrt(max(|a|^2 |b|^2 - (a . b)^2, 1e-12)), a . b)
  with the Lagrange identity in place of the cross product's norm, and the
  clamp that keeps its gradient finite at collinear atoms;
- distances are sqrt(|d|^2 + 1e-12);
- LayerNorm's epsilon is flax's 1e-6 (torch's default is 1e-5), here in
  the two-pass form E[(x - mu)^2];
- a target bond with no triplet (a graph of two atoms) gets 0, and so do
  the bonds of padded slots, which upstream does not have.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from .rbf import (angular_encoding, angular_encoding_freq_bands,
                  gaussian_smearing, gaussian_smearing_offsets)
from .triplet import ACTS

LN_EPS = 1e-6       # flax's LayerNorm default
CROSS_SQ_EPS = 1e-12


def triplets(n: int, device=None):
    """(k, j, i) index lists of every directed triplet of three distinct
    atoms of an n-atom graph, grouped by target bond (j, i)."""
    ar = torch.arange(n, device=device)
    j, i, k = torch.meshgrid(ar, ar, ar, indexing="ij")
    keep = (k != j) & (k != i) & (j != i)
    return k[keep], j[keep], i[keep]


def angle_at(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between the [..., 3] vectors a and b (see the docstring)."""
    dot = (a * b).sum(-1)
    cross_sq = (a * a).sum(-1) * (b * b).sum(-1) - dot * dot
    return torch.atan2(torch.sqrt(torch.clamp(cross_sq, min=CROSS_SQ_EPS)),
                       dot)


def _norm(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * p["scale"] + p["bias"]


def _linear(x, p):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


@dataclasses.dataclass(frozen=True)
class BondUpdateUpstream:
    """The published bond update, called as
    `reference/layers.py::BondUpdateTriplet` is, on the parameter tree of
    its dense mode."""
    hidden_dim: int
    n_heads: int
    norm: bool = True
    act_fn: str = "relu"
    include_h_node: bool = True
    num_ang_funcs: int = 3

    def __call__(self, params, h, h_bond, pos, node_mask, trip_frozen=None):
        """h [B,NL,H]; h_bond [B,NL,NL,H] (src, dst); pos [B,NL,3];
        node_mask [B,NL]. `trip_frozen` (a kNN table of the factorized
        mode) is not used: the published layer takes every source. Returns
        the bond update [B,NL,NL,H], 0 off the real bonds."""
        del trip_frozen
        out = torch.zeros_like(h_bond)
        for b in range(h.shape[0]):
            idx = torch.nonzero(node_mask[b]).flatten()
            n = int(idx.numel())
            if n < 3:
                continue
            hb = h_bond[b][idx][:, idx]                  # [n, n, H] (src, dst)
            upd = self.graph(params, h[b, idx], hb, pos[b, idx])
            out[b, idx[:, None], idx[None, :]] = upd
        return out

    def graph(self, p: Dict, h: torch.Tensor, hb: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
        """One graph of n real atoms: h [n,H], hb [n,n,H], x [n,3] ->
        the update of every bond [n,n,H] (0 on the diagonal)."""
        n, H = h.shape
        heads, dh = self.n_heads, H // self.n_heads
        act = ACTS[self.act_fn]
        k, j, i = triplets(n, h.device)
        pair = j * n + i                              # the target bond
        offsets, coeff = gaussian_smearing_offsets(fix_offset=True)
        dist = lambda a, c: torch.sqrt(((x[a] - x[c]) ** 2).sum(-1) + 1e-12)
        rbf_kj = gaussian_smearing(dist(k, j), offsets, coeff)
        rbf_ji = gaussian_smearing(dist(j, i), offsets, coeff)
        f_kj = [hb[k, j], rbf_kj]
        if self.include_h_node:
            f_kj += [h[k], h[j]]
        f_kj = torch.cat(f_kj, -1)
        enc = angular_encoding(angle_at(x[j] - x[i], x[k] - x[i]),
                               angular_encoding_freq_bands(
                                   self.num_ang_funcs))

        def branch(name):
            pre = (_linear(f_kj, p[f"{name}_kj"])
                   + _linear(rbf_ji, p[f"{name}_ji"])
                   + _linear(enc, p[f"{name}_ang"]))
            if self.norm:
                pre = _norm(pre, p[f"{name}_ln"])
            return _linear(act(pre), p[f"{name}_out"])   # [T, H]

        key, val = branch("hk"), branch("hv")
        # the query of every bond (j, i), read at each triplet's bond
        q_in = hb.reshape(n * n, H)
        if self.include_h_node:
            q_in = torch.cat([q_in, h[None].expand(n, n, H)
                              .reshape(n * n, H)], -1)     # h(i), i = dst
        pq = p["hq"]
        q = _linear(q_in, pq["Dense_0"])
        if self.norm:
            q = _norm(q, pq["LayerNorm_0"])
        q = _linear(act(q), pq["Dense_1"])[pair]             # [T, H]
        score = (q * key).reshape(-1, heads, dh).sum(-1) / math.sqrt(dh)
        # softmax over the triplets of each target bond
        smax = torch.full((n * n, heads), -math.inf, device=h.device,
                          dtype=score.dtype)
        smax = smax.scatter_reduce(0, pair[:, None].expand(-1, heads),
                                   score, "amax", include_self=True)
        e = torch.exp(score - smax[pair])
        den = torch.zeros(n * n, heads, device=h.device,
                          dtype=score.dtype).index_add_(0, pair, e)
        alpha = e / den[pair]
        upd = torch.zeros(n * n, heads, dh, device=h.device,
                          dtype=val.dtype).index_add_(
            0, pair, alpha[..., None] * val.reshape(-1, heads, dh))
        return upd.reshape(n, n, H)
