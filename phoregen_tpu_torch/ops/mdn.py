"""Mixture-density-network atom-count utilities.

Counterpart of `phoregen_tpu/ops/mdn.py` (reference
`models/model_utils.py:436-466`): the mixture's negative log-likelihood in
log space with a sigma floor, and one draw per row from the mixture. As in
the JAX package, no shipped configuration reaches an MDN count head; these
are kept for the same inventory. The draw takes an explicit
`torch.Generator`, as the JAX function takes a key.
"""
from __future__ import annotations

from typing import Optional

import torch

_LOG_2PI = 1.8378770664093453
SIGMA_FLOOR = 1e-6


def mdn_loss(label: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor,
             pi: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of `label` under the Gaussian mixture.

    label: [B]; mu/sigma: [B, K]; pi: [B, K] (rows sum to 1)."""
    sigma = torch.clamp(sigma, min=SIGMA_FLOOR)
    z = (label[:, None] - mu) / sigma
    log_comp = -0.5 * (z * z + _LOG_2PI) - torch.log(sigma)
    log_mix = torch.logsumexp(log_comp + torch.log(pi + 1e-16), dim=1)
    return -log_mix.mean()


def sample_from_mdn(generator: Optional[torch.Generator], mu: torch.Tensor,
                    sigma: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Draw one count per row: component ~ Categorical(pi), then
    mu_k + sigma_k * eps. Returns [B]."""
    B = pi.shape[0]
    comp = torch.multinomial(pi + 1e-16, 1, generator=generator)    # [B, 1]
    eps = torch.randn(B, generator=generator, device=mu.device,
                      dtype=mu.dtype)
    mu_sel = torch.gather(mu, 1, comp)[:, 0]
    sig_sel = torch.gather(sigma, 1, comp)[:, 0]
    return mu_sel + sig_sel * eps
