"""Mask-aware dense primitives and log-space categorical utilities.

Counterpart of `phoregen_tpu/ops/masked.py`. The masked softmax keeps the
denominator floor of 1.0: a row with any valid entry has its max lane at
exp(0) = 1, so the floor never binds there, and a fully masked row returns
zeros with a finite backward (a tiny epsilon gives NaN gradients).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


NEG_INF = -1e9
LOG_EPS = 1e-30
LOG_CLAMP = -32.0


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over `dim` treating mask==False entries as -inf; rows with
    no valid entry return all-zero weights."""
    mask = mask.to(torch.bool)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=dim, keepdim=True).detach()
    e = torch.exp(scores - m) * mask.to(scores.dtype)
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1.0)


def masked_sums(x: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of `x` where mask, sum of the mask in its own shape): the
    numerator and denominator of `masked_mean` over every axis."""
    mask = mask.to(x.dtype)
    return (x * mask).sum(), mask.sum()


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None,
                keepdim: bool = False) -> torch.Tensor:
    """Mean of `x` over entries where mask is True (0 if none). As in the
    JAX package, the denominator sums the mask in its own (broadcastable)
    shape."""
    if dim is None:
        num, den = masked_sums(x, mask)
        return num / torch.clamp(den, min=1e-12)
    mask = mask.to(x.dtype)
    num = (x * mask).sum(dim=dim, keepdim=keepdim)
    den = mask.sum(dim=dim, keepdim=keepdim)
    return num / torch.clamp(den, min=1e-12)


def masked_sum(x: torch.Tensor, mask: torch.Tensor, dim=None,
               keepdim: bool = False) -> torch.Tensor:
    x = x * mask.to(x.dtype)
    return x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)


def masked_logsumexp(x: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                     keepdim: bool = False) -> torch.Tensor:
    x = torch.where(mask.to(torch.bool), x, torch.full_like(x, NEG_INF))
    return torch.logsumexp(x, dim=dim, keepdim=keepdim)


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(x.long(), num_classes).to(
        torch.float32)
    return torch.log(torch.clamp(onehot, min=LOG_EPS))


def gumbel_uniform(shape, generator: Optional[torch.Generator],
                   device) -> torch.Tensor:
    """U[0, 1) draws for Gumbel-max sampling from an explicit generator
    (or rows of a batch's draws: `ops/draws.py`)."""
    return torch.rand(shape, generator=generator, device=device)


def log_sample_categorical(logits: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           uniform: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Gumbel-max sample over the last axis. `uniform` injects the U[0,1)
    draws (tests hand both frameworks the same numbers); otherwise they
    come from `generator`."""
    if uniform is None:
        uniform = gumbel_uniform(logits.shape, generator, logits.device)
    gumbel = -torch.log(-torch.log(uniform + LOG_EPS) + LOG_EPS)
    return torch.argmax(gumbel + logits, dim=-1)


def clamped_log(x: torch.Tensor, eps: float = LOG_EPS) -> torch.Tensor:
    """log(x + eps) clamped below at -32."""
    return torch.clamp(torch.log(x + eps), min=LOG_CLAMP)


def categorical_kl(log_prob1: torch.Tensor, log_prob2: torch.Tensor
                   ) -> torch.Tensor:
    return (torch.exp(log_prob1) * (log_prob1 - log_prob2)).sum(-1)


def log_categorical(log_x_start: torch.Tensor, log_prob: torch.Tensor
                    ) -> torch.Tensor:
    return (torch.exp(log_x_start) * log_prob).sum(-1)
