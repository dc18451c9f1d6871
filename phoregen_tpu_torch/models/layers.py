"""Denoiser building blocks on padded dense graphs, with flax's parameters.

Counterpart of `phoregen_tpu/models/layers.py`. Two kinds of code live
here:

- small `nn.Module`s (`Dense`, `LayerNorm`, `MLP`) for the top-level
  network, and `ParamTree`, which holds a nested tree of parameters under
  flax's names;
- the attention layers (`NodeUpdateKNN`, `NodeUpdateDense`, `PosUpdateKNN`,
  `PosUpdateDense`, `BondUpdateTriplet`) as settings objects that are
  called with a parameter tree, `layer(params, ...)`, the way a flax module
  is applied. `params` is the nested dict of that module in the flax tree
  (`kernel` is [in, out]), so one layer of a stacked (`scan_layers`) tree
  and an unstacked `layer_i` tree are read alike.

Notation: B batch, N = NP + NL composed nodes, NL ligand slots, K kNN
width, H hidden. Two LayerNorm forms are kept apart as in the JAX package:
the edge MLPs use E[x^2] - mu^2 (flax's fast variance), the triplet pools
E[(x - mu)^2].

Mixed precision (`compute_dtype` / `train.dtype` bfloat16) follows the JAX
package: the layers compute in the dtype of the features and parameters
they are given; geometry (positions, distances, angles) stays float32 and
is cast to the feature dtype where it becomes a feature (the RBF grids, the
angle encodings, the direction features); the exact all-k triplet pool is
pinned to float32 and cast at its boundary; the kNN triplet pool follows
the features with its scores and softmax in float32
(`triplet_pool_follow_dtype`). Torch does not promote a bf16 tensor
against a 0-d float32 one and refuses mixed matmuls, so every place where
the JAX code widens by promotion widens explicitly here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ..ops.knn import knn_neighbors
from ..ops.masked import masked_softmax
from ..ops.pallas_triplet import (ACTS, pre_activate, triplet_angle,
                                  triplet_mask, triplet_pool)
from ..ops.rbf import (angular_encoding, angular_encoding_freq_bands,
                       gaussian_smearing, gaussian_smearing_offsets)

_LN_EPS = 1e-6  # flax LayerNorm default

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str, key: str = "compute dtype") -> torch.dtype:
    """The torch dtype of a config value naming one (`compute_dtype`,
    `train.dtype`, `fused_block_dtype`: `key` in the error)."""
    if name not in DTYPES:
        raise ValueError(f"{key} must be float32 or bfloat16, got {name!r}")
    return DTYPES[name]


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2)."""
    return nn.functional.softplus(x) - 0.6931471805599453


def gather_nodes(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """h [B,N,F], idx [B,M,K] -> [B,M,K,F] (h[b, idx[b,m,k]])."""
    B, _, Fd = h.shape
    _, M, K = idx.shape
    flat = torch.gather(h, 1, idx.reshape(B, M * K, 1).long().expand(-1, -1, Fd))
    return flat.reshape(B, M, K, Fd)


# --------------------------------------------------------------------------
# modules of the top-level network
# --------------------------------------------------------------------------

class Dense(nn.Module):
    """y = x @ kernel + bias with flax's [in, out] kernel layout; input and
    kernel are promoted to a common dtype first, as flax's `nn.Dense` does
    (a float32 input on bf16 parameters computes in float32)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim).uniform_(
            -bound, bound))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        if x.dtype != k.dtype:
            dt = torch.promote_types(x.dtype, k.dtype)
            x, k = x.to(dt), k.to(dt)
        y = x @ k
        return y if self.bias is None else y + self.bias


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
               ) -> torch.Tensor:
    """flax `nn.LayerNorm` numerics: var = max(E[x^2] - mu^2, 0)."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class MLP(nn.Module):
    """Dense_0 -> LayerNorm_0 -> relu -> Dense_1 (the two-layer `MLP` of the
    JAX package at its default activation)."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 norm: bool = True):
        super().__init__()
        self.Dense_0 = Dense(in_dim, hidden_dim)
        self.LayerNorm_0 = LayerNorm(hidden_dim) if norm else None
        self.Dense_1 = Dense(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.LayerNorm_0 is not None:
            x = self.LayerNorm_0(x)
        return self.Dense_1(torch.relu(x))


class ParamTree(nn.Module):
    """Nested parameters from a {name: shape or sub-dict} spec; leaf and
    module names follow the flax tree. LayerNorm scales start at 1, biases
    at 0."""

    def __init__(self, spec: Mapping):
        super().__init__()
        for name, sub in spec.items():
            if isinstance(sub, Mapping):
                self.add_module(name, ParamTree(sub))
            elif name == "scale" or name.endswith("ln_scale"):
                self.register_parameter(name, nn.Parameter(torch.ones(*sub)))
            elif name == "bias" or name.endswith("ln_bias"):
                self.register_parameter(name, nn.Parameter(torch.zeros(*sub)))
            else:
                self.register_parameter(
                    name, nn.Parameter(0.02 * torch.randn(*sub)))

    def tree(self) -> Dict:
        out = {}
        for name, p in self.named_parameters(recurse=False):
            out[name] = p
        for name, m in self.named_children():
            out[name] = m.tree()
        return out


# --------------------------------------------------------------------------
# parameter-tree shapes (what a flax init of the same module would create)
# --------------------------------------------------------------------------

def dense_shapes(i: int, o: int, bias: bool = True) -> Dict:
    return {"kernel": (i, o), "bias": (o,)} if bias else {"kernel": (i, o)}


def mlp_shapes(i: int, o: int, hidden: int, norm: bool = True) -> Dict:
    out = {"Dense_0": dense_shapes(i, hidden)}
    if norm:
        out["LayerNorm_0"] = {"scale": (hidden,), "bias": (hidden,)}
    out["Dense_1"] = dense_shapes(hidden, o)
    return out


# --------------------------------------------------------------------------
# functional pieces over parameter trees
# --------------------------------------------------------------------------

def _mlp_parts(p):
    """{Dense_0, LayerNorm_0?, Dense_1} -> (k0, b0, ln or None, k1, b1)."""
    ln = p.get("LayerNorm_0")
    return (p["Dense_0"]["kernel"], p["Dense_0"]["bias"],
            (ln["scale"], ln["bias"]) if ln is not None else None,
            p["Dense_1"]["kernel"], p["Dense_1"]["bias"])


def _fast_ln(x, scale, bias):
    """E[x^2] - mu^2 LayerNorm as the edge MLPs of the JAX package write it
    (no clamp of the variance)."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


def mlp_apply(p, x, act):
    """Apply an MLP parameter tree as flax's `MLP` module does (flax's
    LayerNorm clamps its fast variance at 0)."""
    k0, b0, ln, k1, b1 = _mlp_parts(p)
    y = x @ k0 + b0
    if ln is not None:
        y = layer_norm(y, *ln)
    return act(y) @ k1 + b1


def _ln_act_blocks(x, lns, act):
    """LayerNorm per trailing-H block + activation over x [..., P, H];
    lns = P (scale, bias) pairs, or Nones when norm is off."""
    if lns[0] is not None:
        scale = torch.stack([s for s, _ in lns])
        bias = torch.stack([b for _, b in lns])
        x = _fast_ln(x, scale, bias)
    return act(x)


def _apply_mlp_params(p, x, act):
    """The 'concat' application style: a plain 2-layer MLP over a
    pre-concatenated input. `p` = `_mlp_parts(...)`."""
    k0, b0, ln, k1, b1 = p
    y = x @ k0 + b0
    if ln is not None:
        y = _fast_ln(y, *ln)
    return act(y) @ k1 + b1


def _pair_first_layer(edge_feat, h, p_k, p_v, fe, hn):
    """First linear layer of the parallel k and v edge MLPs over
    concat([edge_feat, h_i, h_j]) as split products: the edge term on the
    grid once for both, the node terms on the node axis. Returns
    (edge_pre [.., 2H], node_i [B,N,2H], node_j [B,N,2H])."""
    k0k, b0k = p_k[0], p_k[1]
    k0v, b0v = p_v[0], p_v[1]
    we = torch.cat([k0k[:fe], k0v[:fe]], 1)
    wn = torch.cat([k0k[fe:fe + hn], k0v[fe:fe + hn],
                    k0k[fe + hn:], k0v[fe + hn:]], 1)
    nproj = h @ wn                                            # [B,N,4H]
    hh = nproj.shape[-1] // 2
    edge_pre = edge_feat @ we + torch.cat([b0k, b0v])
    return edge_pre, nproj[..., :hh], nproj[..., hh:]


def _edge_kv(p_k, p_v, edge_feat, h, on_i, on_j, act, style, hidden: int,
             stacked_second: bool):
    """k and v of one edge attention over concat([edge_feat, h_i, h_j]).
    `on_i` / `on_j` place a per-node tensor [B,N,F] on the edge grid at the
    destination / source of each edge (broadcastable to it)."""
    fe = edge_feat.shape[-1]
    H = h.shape[-1]
    if style == "concat":
        grid = edge_feat.shape[:-1]
        feat = torch.cat([edge_feat, on_i(h).expand(*grid, H),
                          on_j(h).expand(*grid, H)], -1)
        return (_apply_mlp_params(p_k, feat, act),
                _apply_mlp_params(p_v, feat, act))
    edge_pre, node_i, node_j = _pair_first_layer(edge_feat, h, p_k, p_v, fe, H)
    pre = edge_pre + on_i(node_i) + on_j(node_j)
    x = _ln_act_blocks(pre.reshape(*pre.shape[:-1], 2, hidden),
                       (p_k[2], p_v[2]), act)
    if stacked_second:
        k1 = torch.stack([p_k[3], p_v[3]])
        b1 = torch.stack([p_k[4], p_v[4]])
        kv = torch.einsum("...ph,pho->...po", x, k1) + b1
        return kv[..., 0, :], kv[..., 1, :]
    return (x[..., 0, :] @ p_k[3] + p_k[4], x[..., 1, :] @ p_v[3] + p_v[4])


def _knn_grid(nbr_idx):
    """(on_i, on_j) for the [B,N,K] kNN table: destination = row, source =
    gathered neighbour."""
    return (lambda t: t[:, :, None, :], lambda t: gather_nodes(t, nbr_idx))


# (on_i, on_j) for the dense [B,src,dst] grid: h_i = destination (axis 2),
# h_j = source (axis 1)
_DENSE_GRID = (lambda t: t[:, None, :, :], lambda t: t[:, :, None, :])


@dataclasses.dataclass(frozen=True)
class _AttentionSettings:
    hidden_dim: int
    n_heads: int
    norm: bool = True
    act_fn: str = "relu"
    apply_style: str = "split"

    @property
    def act(self):
        return ACTS[self.act_fn]

    @property
    def d_head(self):
        return self.hidden_dim // self.n_heads


def _node_shapes(edge_dim, hidden, norm=True, out_fc=False) -> Dict:
    i = edge_dim + 2 * hidden
    out = {"hk": mlp_shapes(i, hidden, hidden, norm),
           "hv": mlp_shapes(i, hidden, hidden, norm),
           "hq": mlp_shapes(hidden, hidden, hidden, norm)}
    if out_fc:
        out["node_output"] = mlp_shapes(2 * hidden, hidden, hidden, norm)
    return out


def _node_out(s, params, out, h):
    if s.out_fc:
        out = mlp_apply(params["node_output"], torch.cat([out, h], -1), s.act)
    return out


@dataclasses.dataclass(frozen=True)
class NodeUpdateKNN(_AttentionSettings):
    """Multi-head attention node update over the kNN neighbour table."""
    out_fc: bool = False

    shapes = staticmethod(_node_shapes)

    def __call__(self, params, h, edge_feat, nbr_idx, nbr_mask, e_w=None):
        """h [B,N,H]; edge_feat [B,N,K,Fe]; nbr_idx / nbr_mask [B,N,K]."""
        B, N, _ = h.shape
        K = nbr_idx.shape[-1]
        k, v = _edge_kv(
            _mlp_parts(params["hk"]), _mlp_parts(params["hv"]), edge_feat, h,
            *_knn_grid(nbr_idx), self.act, self.apply_style, self.hidden_dim,
            True)
        if e_w is not None:
            v = v * e_w[..., None]
        q = mlp_apply(params["hq"], h, self.act)
        k = k.reshape(B, N, K, self.n_heads, self.d_head)
        v = v.reshape(B, N, K, self.n_heads, self.d_head)
        q = q.reshape(B, N, 1, self.n_heads, self.d_head)
        scores = (q * k).sum(-1) / float(np.sqrt(self.d_head))
        alpha = masked_softmax(scores, nbr_mask[..., None], dim=2)
        out = (alpha[..., None] * v).sum(2).reshape(B, N, self.hidden_dim)
        return _node_out(self, params, out, h)


@dataclasses.dataclass(frozen=True)
class NodeUpdateDense(_AttentionSettings):
    """Node update attending over the dense [src, dst] pair grid: ligand
    bond messages (edge feature = bond hidden state) and the phore
    self-encoder (edge feature = pairwise distance, self loops kept)."""
    out_fc: bool = False

    shapes = staticmethod(_node_shapes)

    def __call__(self, params, h, edge_feat, pair_mask, e_w=None):
        """h [B,N,H]; edge_feat [B,src,dst,Fe]; pair_mask [B,src,dst]."""
        B, N, _ = h.shape
        k, v = _edge_kv(
            _mlp_parts(params["hk"]), _mlp_parts(params["hv"]), edge_feat, h,
            *_DENSE_GRID, self.act, self.apply_style, self.hidden_dim, True)
        if e_w is not None:
            v = v * e_w[..., None]
        q = mlp_apply(params["hq"], h, self.act)
        k = k.reshape(B, N, N, self.n_heads, self.d_head)
        v = v.reshape(B, N, N, self.n_heads, self.d_head)
        q = q.reshape(B, 1, N, self.n_heads, self.d_head)
        scores = (q * k).sum(-1) / float(np.sqrt(self.d_head))
        alpha = masked_softmax(scores, pair_mask[..., None], dim=1)
        out = (alpha[..., None] * v).sum(1).reshape(B, N, self.hidden_dim)
        return _node_out(self, params, out, h)


def _pos_shapes(edge_dim, hidden, heads, norm=True) -> Dict:
    i = edge_dim + 2 * hidden
    return {"xk": mlp_shapes(i, hidden, hidden, norm),
            "xv": mlp_shapes(i, heads, hidden, norm),
            "xq": mlp_shapes(hidden, hidden, hidden, norm)}


@dataclasses.dataclass(frozen=True)
class PosUpdateKNN(_AttentionSettings):
    """Equivariant position update over the kNN table: value = scalar per
    head times rel_x, output = mean over heads."""

    shapes = staticmethod(_pos_shapes)

    def __call__(self, params, h, rel_x, edge_feat, nbr_idx, nbr_mask,
                 e_w=None):
        """rel_x [B,N,K,3] = x[dst] - x[src]."""
        B, N, _ = h.shape
        K = nbr_idx.shape[-1]
        k, v = _edge_kv(
            _mlp_parts(params["xk"]), _mlp_parts(params["xv"]), edge_feat, h,
            *_knn_grid(nbr_idx), self.act, self.apply_style, self.hidden_dim,
            False)
        if e_w is not None:
            v = v * e_w[..., None]
        v = v[..., None] * rel_x[:, :, :, None, :]            # [B,N,K,heads,3]
        q = mlp_apply(params["xq"], h, self.act)
        k = k.reshape(B, N, K, self.n_heads, self.d_head)
        q = q.reshape(B, N, 1, self.n_heads, self.d_head)
        scores = (q * k).sum(-1) / float(np.sqrt(self.d_head))
        alpha = masked_softmax(scores, nbr_mask[..., None], dim=2)
        return (alpha[..., None] * v).sum(2).mean(2)          # [B,N,3]


@dataclasses.dataclass(frozen=True)
class PosUpdateDense(_AttentionSettings):
    """Equivariant position update over the dense ligand bond grid."""

    shapes = staticmethod(_pos_shapes)

    def __call__(self, params, h, rel_x, edge_feat, pair_mask, e_w=None):
        """rel_x [B,src,dst,3] = x[dst] - x[src]; edge_feat on that grid."""
        B, N, _ = h.shape
        k, v = _edge_kv(
            _mlp_parts(params["xk"]), _mlp_parts(params["xv"]), edge_feat, h,
            *_DENSE_GRID, self.act, self.apply_style, self.hidden_dim, False)
        if e_w is not None:
            v = v * e_w[..., None]
        v = v[..., None] * rel_x[:, :, :, None, :]            # [B,N,N,heads,3]
        q = mlp_apply(params["xq"], h, self.act)
        k = k.reshape(B, N, N, self.n_heads, self.d_head)
        q = q.reshape(B, 1, N, self.n_heads, self.d_head)
        scores = (q * k).sum(-1) / float(np.sqrt(self.d_head))
        alpha = masked_softmax(scores, pair_mask[..., None], dim=1)
        return (alpha[..., None] * v).sum(1).mean(2)


@dataclasses.dataclass(frozen=True)
class BondUpdateTriplet(_AttentionSettings):
    """Triplet (k -> j -> i) angular attention over the dense ligand grid:
    alpha over the sources k of each target bond (j, i), k != i.

    mode 'factorized': per-triplet features pre_kji = act(LN(a_kj + a_ji +
    a_ang)) at width `width`; logits are q_ji . pre_kji per head and the
    value path pools pre itself. With 0 < knn_k < N-1 the sources are the
    knn_k nearest neighbours of j (`_pool_knn`); otherwise all k, through
    `ops/pallas_triplet.py::triplet_pool` (`use_pallas` selects its
    kernel). mode 'dense': per-triplet k/v features at the full hidden
    width."""
    include_h_node: bool = True
    num_ang_funcs: int = 3
    mode: str = "factorized"
    width: int = 32
    use_pallas: bool = False
    knn_k: int = 0
    # the kNN pool runs in the feature dtype (bf16 under mixed precision),
    # scores and softmax in float32; no effect at float32 or on the all-k
    # pool, which is always float32
    pool_follow_dtype: bool = True

    @staticmethod
    def shapes(hidden, heads, norm=True, include_h_node=True, num_ang=3,
               mode="factorized", width=32, rf_dim=20) -> Dict:
        enc = 1 + 4 * num_ang
        in_kj = hidden + rf_dim + (2 * hidden if include_h_node else 0)
        in_q = hidden + (hidden if include_h_node else 0)
        if mode == "factorized":
            out = {"tf_ang_w": (enc, width),
                   "tf_ji": dense_shapes(rf_dim, width, bias=False),
                   "tf_kj": dense_shapes(in_kj, width)}
            if norm:
                out.update(tf_ln_bias=(width,), tf_ln_scale=(width,))
            out.update(tf_out=dense_shapes(heads * width, hidden),
                       tf_q=mlp_shapes(in_q, heads * width, hidden, norm))
            return out
        out = {"hq": mlp_shapes(in_q, hidden, hidden, norm)}
        for name in ("hk", "hv"):
            out[f"{name}_kj"] = dense_shapes(in_kj, hidden)
            out[f"{name}_ji"] = dense_shapes(rf_dim, hidden, bias=False)
            out[f"{name}_ang"] = dense_shapes(enc, hidden, bias=False)
            out[f"{name}_out"] = dense_shapes(hidden, hidden)
            if norm:
                out[f"{name}_ln"] = {"scale": (hidden,), "bias": (hidden,)}
        return out

    def __call__(self, params, h, h_bond, pos, node_mask, trip_frozen=None):
        """h [B,NL,H]; h_bond [B,NL,NL,H] (src, dst); pos [B,NL,3];
        node_mask [B,NL]; trip_frozen: optional (idx, mask) kNN table for
        the source restriction. Returns the bond update [B,NL,NL,H]."""
        with record_function("bond.triplet"):
            rel = pos[:, :, None, :] - pos[:, None, :, :]  # rel[x,i] = x - i
            dist = torch.sqrt((rel * rel).sum(-1) + 1e-12)
            # the distance features drop to the feature dtype (pos stays f32)
            r_feat = gaussian_smearing(
                dist, *gaussian_smearing_offsets(fix_offset=True)).to(h.dtype)
            if self.mode == "factorized":
                return self._factorized(params, h, h_bond, r_feat, pos,
                                        node_mask, trip_frozen)
            return self._dense(params, h, h_bond, r_feat, rel, node_mask)

    def _dense(self, p, h, h_bond, r_feat, rel, node_mask):
        B, N, H = h.shape
        act = self.act
        angle = triplet_angle(rel[:, :, None], rel[:, None])  # [B,j,k,i]
        a_feat = angular_encoding(
            angle, angular_encoding_freq_bands(self.num_ang_funcs)
        ).to(h.dtype)
        tri_mask = triplet_mask(node_mask)                    # [B,k,j,i]
        hk_exp = h[:, :, None, :].expand(B, N, N, H)          # h[src=k]
        hj_exp = h[:, None, :, :].expand(B, N, N, H)          # h[dst=j]
        f_kj = torch.cat([h_bond, r_feat] + (
            [hk_exp, hj_exp] if self.include_h_node else []), -1)

        def branch(name):
            a_kj = f_kj @ p[f"{name}_kj"]["kernel"] + p[f"{name}_kj"]["bias"]
            a_ji = r_feat @ p[f"{name}_ji"]["kernel"]
            a_ang = a_feat @ p[f"{name}_ang"]["kernel"]       # [B,j,k,i,H]
            pre = (a_kj[:, :, :, None, :] + a_ji[:, None, :, :, :]
                   + a_ang.transpose(1, 2))                   # [B,k,j,i,H]
            if self.norm:
                pre = layer_norm(pre, p[f"{name}_ln"]["scale"],
                                 p[f"{name}_ln"]["bias"])
            return act(pre) @ p[f"{name}_out"]["kernel"] \
                + p[f"{name}_out"]["bias"]

        k_t, v_t = branch("hk"), branch("hv")
        q_input = torch.cat([h_bond, hj_exp], -1) if self.include_h_node \
            else h_bond                                       # h[dst=i]
        q = mlp_apply(p["hq"], q_input, act)                  # [B,j,i,H]
        k_t = k_t.reshape(B, N, N, N, self.n_heads, self.d_head)
        v_t = v_t.reshape(B, N, N, N, self.n_heads, self.d_head)
        q = q.reshape(B, 1, N, N, self.n_heads, self.d_head)
        scores = (q * k_t).sum(-1) / float(np.sqrt(self.d_head))
        alpha = masked_softmax(scores, tri_mask[..., None], dim=1)
        return (alpha[..., None] * v_t).sum(1).reshape(B, N, N,
                                                       self.hidden_dim)

    def _factorized(self, p, h, h_bond, r_feat, pos, node_mask, trip_frozen):
        B, N, H = h.shape
        Wt, heads = self.width, self.n_heads
        rf = r_feat.shape[-1]
        k_kj, b_kj = p["tf_kj"]["kernel"], p["tf_kj"]["bias"]
        if self.apply_style == "concat":
            parts = [h_bond, r_feat]
            if self.include_h_node:
                parts += [h[:, :, None, :].expand(B, N, N, H),
                          h[:, None, :, :].expand(B, N, N, H)]
            a_kj = torch.cat(parts, -1) @ k_kj + b_kj
        else:
            a_kj = h_bond @ k_kj[:H] + r_feat @ k_kj[H:H + rf] + b_kj
            if self.include_h_node:
                nproj = h @ torch.cat([k_kj[H + rf:H + rf + H],
                                       k_kj[H + rf + H:]], 1)  # [B,N,2Wt]
                a_kj = (a_kj + nproj[..., :Wt][:, :, None, :]  # h[src=k]
                        + nproj[..., Wt:][:, None, :, :])      # h[dst=j]
        a_ji = r_feat @ p["tf_ji"]["kernel"]
        w_ang = p["tf_ang_w"]
        ln_scale = p["tf_ln_scale"] if self.norm else h.new_ones(Wt)
        ln_bias = p["tf_ln_bias"] if self.norm else h.new_zeros(Wt)

        pq = _mlp_parts(p["tf_q"])
        if self.apply_style == "concat":
            q_in = h_bond
            if self.include_h_node:
                q_in = torch.cat(
                    [h_bond, h[:, None, :, :].expand(B, N, N, H)], -1)
            q = _apply_mlp_params(pq, q_in, self.act)
        else:
            q_pre = h_bond @ pq[0][:H] + pq[1]
            if self.include_h_node:
                q_pre = q_pre + (h @ pq[0][H:])[:, None, :, :]  # h[dst=i]
            q = _ln_act_blocks(q_pre[..., None, :], (pq[2],),
                               self.act)[..., 0, :]
            q = q @ pq[3] + pq[4]
        q = q.reshape(B, N, N, heads, Wt)

        # the all-k pool always runs float32 (its kernel is float32 only);
        # the kNN pool may follow a bf16 feature dtype
        f32 = lambda t: t.float().contiguous()
        if 0 < self.knn_k < N - 1:
            cast = ((lambda t: t.to(h.dtype))
                    if self.pool_follow_dtype and h.dtype != torch.float32
                    else f32)
            pooled = self._pool_knn(cast(a_kj), cast(a_ji), cast(q), pos,
                                    node_mask, cast(w_ang), cast(ln_scale),
                                    cast(ln_bias), trip_frozen)
        else:
            pooled = triplet_pool(
                f32(a_kj), f32(a_ji), f32(q), pos.contiguous(), node_mask,
                f32(w_ang), f32(ln_scale), f32(ln_bias), self.act_fn,
                self.norm, num_ang_funcs=self.num_ang_funcs,
                use_pallas=self.use_pallas)
        return (pooled.to(h.dtype) @ p["tf_out"]["kernel"]
                + p["tf_out"]["bias"])

    def _pool_knn(self, a_kj, a_ji, q, pos, node_mask, w_ang, ln_scale,
                  ln_bias, trip_frozen=None):
        """k restricted to the K nearest neighbours of j: O(NL^2 K) grids."""
        B, N, _, Wt = a_kj.shape
        heads = q.shape[-2]
        if trip_frozen is not None:
            nbr_idx, nbr_mask = trip_frozen
        else:
            nbr_idx, nbr_mask = knn_neighbors(pos, node_mask, self.knn_k)
        nbr_idx = nbr_idx.long()
        # a_kj[b, k, j] at k = nbr_idx[b, j, :] -> [B, j, K, Wt]
        a_kj_j = torch.gather(
            a_kj.transpose(1, 2), 2,
            nbr_idx[..., None].expand(-1, -1, -1, Wt))
        pos_k = gather_nodes(pos, nbr_idx)                    # [B,j,K,3]
        rel_ji = pos[:, :, None, :] - pos[:, None, :, :]      # [B,j,i,3]
        rel_ki = pos_k[:, :, :, None, :] - pos[:, None, None, :, :]
        angle = triplet_angle(rel_ji[:, :, None], rel_ki)     # [B,j,K,i]
        # geometry stays f32; the encoding drops to the pool dtype
        a_ang = angular_encoding(
            angle, angular_encoding_freq_bands(self.num_ang_funcs)
        ).to(w_ang.dtype) @ w_ang
        pre = a_kj_j[:, :, :, None, :] + a_ji[:, :, None, :, :] + a_ang
        pre = pre_activate(pre, ln_scale, ln_bias, self.act_fn, self.norm)
        # scores and softmax in float32 whatever the pool dtype (bf16
        # products are exact in float32, as XLA's preferred_element_type)
        scores = torch.einsum("bjkiw,bjihw->bjkih", pre.float(), q.float()) \
            / float(np.sqrt(Wt))
        # k a valid neighbour of j; i and j valid; k != i; i != j (k != j
        # holds because a kNN row leaves out its own node)
        idx = torch.arange(N, device=pos.device)
        neq_ki = nbr_idx[..., None] != idx
        neq_ji = (idx[:, None] != idx[None, :])[None, :, None, :]
        nm = node_mask.to(torch.bool)
        valid = (nbr_mask.to(torch.bool)[..., None] & nm[:, None, None, :]
                 & nm[:, :, None, None] & neq_ki & neq_ji)
        alpha = masked_softmax(scores, valid[..., None], dim=2)
        pooled = torch.einsum("bjkih,bjkiw->bjihw", alpha.to(pre.dtype), pre)
        return pooled.reshape(B, N, N, heads * Wt)
