"""Dense masked k-NN graph construction.

Counterpart of `phoregen_tpu/ops/knn.py::knn_neighbors`: each destination
node gets a fixed-width row of k source indices plus a validity mask, from
a top-k over the masked pairwise squared distances. `torch.topk` does not
promise `lax.top_k`'s lower-index-first order among exact ties; masked
slots are inert downstream, so only the valid neighbour SET matters.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INF = 1e30


def pairwise_sq_dist(x: torch.Tensor) -> torch.Tensor:
    """Squared distances by the direct difference form: [..., N, 3] -> [..., N, N]."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return (diff * diff).sum(-1)


def knn_neighbors(x: torch.Tensor, mask: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,N,3], mask [B,N] bool -> (nbr_idx [B,N,K] int64, nbr_mask [B,N,K]
    bool) with K = min(k, N-1): the k nearest valid sources j != i of each
    destination i, nearest first."""
    B, N = mask.shape
    k = min(k, N - 1)
    mask = mask.to(torch.bool)
    d2 = pairwise_sq_dist(x)
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    valid = mask[:, None, :] & mask[:, :, None] & ~eye
    d2 = torch.where(valid, d2, torch.full_like(d2, _INF))
    neg, idx = torch.topk(-d2, k, dim=-1, largest=True, sorted=True)
    return idx, neg > -_INF * 0.5
