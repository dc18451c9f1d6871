"""Dense masked k-NN graph construction.

Counterpart of `phoregen_tpu/ops/knn.py`: each destination node gets a
fixed-width row of source indices plus a validity mask, taken from the
masked pairwise squared distances (`knn_neighbors`), optionally cut at a
radius (`radius_neighbors`) or built as the hybrid ligand-dense /
phore-kNN table (`hybrid_neighbors`).

`lax.top_k` breaks exact ties toward the lower index. `torch.topk` does
not promise that on CUDA, so the k smallest are taken from a stable sort,
which does.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INF = 1e30


def pairwise_sq_dist(x: torch.Tensor) -> torch.Tensor:
    """Squared distances by the direct difference form: [..., N, 3] -> [..., N, N]."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    return (diff * diff).sum(-1)


def _smallest_k(d2: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ascending, exact ties in
    index order -> (values, indices)."""
    val, idx = torch.sort(d2, dim=-1, stable=True)
    return val[..., :k], idx[..., :k]


def _masked_sq_dist(x: torch.Tensor, mask: torch.Tensor):
    """(raw d2, valid_pair [B,dst,src], d2 with invalid pairs at _INF)."""
    N = mask.shape[1]
    mask = mask.to(torch.bool)
    d2 = pairwise_sq_dist(x)
    eye = torch.eye(N, dtype=torch.bool, device=x.device)
    valid = mask[:, None, :] & mask[:, :, None] & ~eye
    return d2, valid, torch.where(valid, d2, torch.full_like(d2, _INF))


def knn_neighbors(x: torch.Tensor, mask: torch.Tensor, k: int,
                  return_d2: bool = False) -> Tuple[torch.Tensor, ...]:
    """x [B,N,3], mask [B,N] bool -> (nbr_idx [B,N,K] int64, nbr_mask [B,N,K]
    bool) with K = min(k, N-1): the k nearest valid sources j != i of each
    destination i, nearest first. With `return_d2`, also the masked
    [B,N,N] squared distances (`_INF` on padded pairs and the diagonal)."""
    k = min(k, mask.shape[1] - 1)
    _, _, d2m = _masked_sq_dist(x, mask)
    val, idx = _smallest_k(d2m, k)
    if return_d2:
        return idx, val < _INF * 0.5, d2m
    return idx, val < _INF * 0.5


def radius_neighbors(x: torch.Tensor, mask: torch.Tensor, k: int, r: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radius graph capped at k neighbours: the k nearest valid sources
    that lie within `r` of the destination."""
    idx, nbr_mask, d2 = knn_neighbors(x, mask, k, return_d2=True)
    return idx, nbr_mask & (d2.gather(-1, idx) <= r * r)


def hybrid_neighbors(x: torch.Tensor, mask: torch.Tensor, num_phore: int,
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hybrid cutoff on the composed layout [phore(NP); ligand(NL)]:
    ligand destinations receive all other ligand atoms plus their k nearest
    phore points; phore destinations their k nearest among all nodes.
    Returns a [B, N, NL + k] table (ligand rows: NL ligand slots with self
    and padding masked, then k phore slots; phore rows: k slots, rest
    masked)."""
    B, N = mask.shape
    NP = num_phore
    NL = N - NP
    k = min(k, N - 1)
    mask = mask.to(torch.bool)
    d2, valid, d2m = _masked_sq_dist(x, mask)
    dev = x.device
    width = NL + k

    lig_src = torch.arange(NP, N, device=dev)[None, None, :].expand(B, NL, NL)
    d2_lp = torch.where(mask[:, None, :NP] & mask[:, NP:, None],
                        d2[:, NP:, :NP], torch.full_like(d2[:, NP:, :NP], _INF))
    kp = min(k, NP)
    val, lp_idx = _smallest_k(d2_lp, kp)
    lp_mask = val < _INF * 0.5
    if k > kp:
        lp_idx = torch.cat([lp_idx, lp_idx.new_zeros(B, NL, k - kp)], -1)
        lp_mask = torch.cat([lp_mask, lp_mask.new_zeros(B, NL, k - kp)], -1)
    lig_idx = torch.cat([lig_src, lp_idx], -1)
    lig_mask = torch.cat([valid[:, NP:, NP:], lp_mask], -1)

    valp, p_idx = _smallest_k(d2m[:, :NP], k)
    p_mask = valp < _INF * 0.5
    p_idx = torch.cat([p_idx, p_idx.new_zeros(B, NP, width - k)], -1)
    p_mask = torch.cat([p_mask, p_mask.new_zeros(B, NP, width - k)], -1)
    return torch.cat([p_idx, lig_idx], 1), torch.cat([p_mask, lig_mask], 1)
