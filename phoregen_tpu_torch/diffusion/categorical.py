"""D3PM-style categorical transition with absorbing priors: the sampling half.

Counterpart of `phoregen_tpu/diffusion/categorical.py`: the 'tomask' /
'absorb' / 'uniform' priors, prior draws, the posterior with explicit
(possibly multi-step) [K, K] tables, and the strided table builder. Tables
are built on the host in float64 and used as float32.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..ops.masked import clamped_log, index_to_log_onehot, log_sample_categorical

EPS = 1e-30


def build_init_prob(num_classes: int, init_prob: Union[str, np.ndarray, None]
                    ) -> np.ndarray:
    if init_prob is None or init_prob == "uniform":
        p = np.ones(num_classes) / num_classes
    elif init_prob == "absorb":  # absorb into class 0 (no-bond)
        p = 0.01 * np.ones(num_classes)
        p[0] = 1.0
        p = p / p.sum()
    elif init_prob == "tomask":  # absorb into the trailing mask class
        p = 0.001 * np.ones(num_classes)
        p[-1] = 1.0
        p = p / p.sum()
    else:
        p = np.asarray(init_prob, dtype=np.float64)
        p = p / p.sum()
    return p


def _one_step_mats(betas: np.ndarray, prob: np.ndarray):
    """Per-step Q_t and cumulative Q-bar_t (host-side float64)."""
    num_classes = prob.shape[0]
    one_step = []
    for beta_t in betas:
        mat = beta_t * np.repeat(prob[None, :], num_classes, axis=0)
        mat = mat + np.eye(num_classes) * (1.0 - beta_t)
        one_step.append(mat)
    cum = [one_step[0]]
    for t in range(1, len(betas)):
        cum.append(cum[-1] @ one_step[t])
    return np.stack(one_step, axis=0), np.stack(cum, axis=0)


class CategoricalTransition:
    def __init__(self, betas: np.ndarray, num_classes: int,
                 init_prob: Union[str, np.ndarray, None] = None):
        self.num_classes = num_classes
        prob = build_init_prob(num_classes, init_prob)
        self.init_logprob = np.clip(np.log(prob + EPS), -32.0, None
                                    ).astype(np.float32)

    @staticmethod
    def q_v_posterior_mats(log_v0: torch.Tensor, log_vt: torch.Tensor,
                           trans_T: torch.Tensor, cum_prev: torch.Tensor,
                           is_final: bool) -> torch.Tensor:
        """log q(v_prev | v_t, v_0) with [K, K] tables shared by the batch;
        `is_final` returns log_v0 (the t = 0 override)."""
        if is_final:
            return log_v0
        fact1 = (torch.exp(log_vt)[..., :, None] * trans_T).sum(-2)
        fact2 = (torch.exp(log_v0)[..., :, None] * cum_prev).sum(-2)
        out = clamped_log(fact1) + clamped_log(fact2)
        return out - torch.logsumexp(out, dim=-1, keepdim=True)

    def sample_init(self, shape, generator: Optional[torch.Generator] = None,
                    device="cpu", uniform: Optional[torch.Tensor] = None):
        """v_T from the stationary prior over a [B, ...] grid ->
        (class ids, one-hot, log one-hot)."""
        logits = torch.as_tensor(self.init_logprob, device=device).expand(
            tuple(shape) + (self.num_classes,))
        init_types = log_sample_categorical(logits, generator, uniform)
        onehot = torch.nn.functional.one_hot(init_types, self.num_classes
                                             ).to(torch.float32)
        return init_types, onehot, index_to_log_onehot(init_types,
                                                       self.num_classes)


def build_strided_tables(betas: np.ndarray, num_classes: int, init_prob,
                         timesteps: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact multi-step posterior tables (trans_T [S-1,K,K], cum_prev
    [S-1,K,K], float32) for descending timesteps ending at 0:
    q(v_prev | v_t, v_0) ∝ (Q_{prev->t}^T v_t) ⊙ (Q̄_prev v_0)."""
    betas = np.asarray(betas, np.float64)
    prob = build_init_prob(num_classes, init_prob)
    one_step, cum = _one_step_mats(betas, prob)
    ts = np.asarray(timesteps, np.int64)
    assert ts[-1] == 0 and (len(ts) == 1 or (np.diff(ts) < 0).all()), \
        "timesteps must descend to 0"
    trans_T, cum_prev = [], []
    for i in range(len(ts) - 1):
        t, tp = int(ts[i]), int(ts[i + 1])
        q = np.eye(num_classes)
        for s in range(tp + 1, t + 1):
            q = q @ one_step[s]
        trans_T.append(q.T)
        cum_prev.append(cum[tp])
    K = num_classes
    if not trans_T:
        empty = np.zeros((0, K, K), np.float32)
        return empty, empty
    return (np.stack(trans_T).astype(np.float32),
            np.stack(cum_prev).astype(np.float32))
