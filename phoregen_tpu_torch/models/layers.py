"""Building blocks the sampling slice needs, with flax's parameter names.

Counterpart of the parts of `phoregen_tpu/models/layers.py` that the fused
sampling path runs outside the layer stack: `Dense`, `LayerNorm`, `MLP`,
`shifted_softplus` and `NodeUpdateDense` in the 'split' apply style (the
phore self-encoder). Parameters keep flax's names and layouts (`kernel` is
[in, out]) so a flax param tree maps onto `state_dict` by joining its path
with '.'. `ParamTree` holds parameters that only a fused kernel reads (the
stacked per-layer weights).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
from torch import nn

from ..ops.masked import masked_softmax

_LN_EPS = 1e-6  # flax LayerNorm default


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log(2)."""
    return nn.functional.softplus(x) - 0.6931471805599453


class Dense(nn.Module):
    """y = x @ kernel + bias with flax's [in, out] kernel layout."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim).uniform_(
            -bound, bound))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel
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
    JAX package with norm=True and act 'relu')."""

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


class NodeUpdateDense(nn.Module):
    """Multi-head attention over the dense [src, dst] pair grid, 'split'
    apply style (edge term on the grid, node terms on the node axis); used
    by the phore self-encoder with the pairwise distance as edge feature."""

    def __init__(self, edge_dim: int, hidden_dim: int, n_heads: int,
                 norm: bool = True):
        super().__init__()
        in_dim = edge_dim + 2 * hidden_dim
        self.fe = edge_dim
        self.hidden_dim = hidden_dim
        self.n_heads = n_heads
        self.hk = MLP(in_dim, hidden_dim, hidden_dim, norm)
        self.hv = MLP(in_dim, hidden_dim, hidden_dim, norm)
        self.hq = MLP(hidden_dim, hidden_dim, hidden_dim, norm)

    def forward(self, h: torch.Tensor, edge_feat: torch.Tensor,
                pair_mask: torch.Tensor) -> torch.Tensor:
        """h [B,N,H]; edge_feat [B,src,dst,Fe]; pair_mask [B,src,dst]."""
        B, N, H = h.shape
        fe, dh = self.fe, H // self.n_heads
        outs = []
        for p in (self.hk, self.hv):
            W = p.Dense_0.kernel
            # h_i = destination (axis 2), h_j = source (axis 1)
            pre = (edge_feat @ W[:fe] + p.Dense_0.bias
                   + (h @ W[fe:fe + H])[:, None, :, :]
                   + (h @ W[fe + H:])[:, :, None, :])
            if p.LayerNorm_0 is not None:
                pre = p.LayerNorm_0(pre)
            outs.append(p.Dense_1(torch.relu(pre)))
        k, v = outs
        q = self.hq(h)
        k = k.reshape(B, N, N, self.n_heads, dh)
        v = v.reshape(B, N, N, self.n_heads, dh)
        q = q.reshape(B, 1, N, self.n_heads, dh)
        scores = (q * k).sum(-1) / float(math.sqrt(dh))    # [B,src,dst,heads]
        alpha = masked_softmax(scores, pair_mask[..., None], dim=1)
        return (alpha[..., None] * v).sum(1).reshape(B, N, H)


class ParamTree(nn.Module):
    """Nested parameters from a {name: shape or sub-dict} spec; leaf and
    module names follow the flax tree."""

    def __init__(self, spec: Mapping):
        super().__init__()
        for name, sub in spec.items():
            if isinstance(sub, Mapping):
                self.add_module(name, ParamTree(sub))
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
