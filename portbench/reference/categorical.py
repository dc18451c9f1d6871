"""D3PM-style categorical transition with absorbing priors.

Counterpart of `phoregen_tpu/diffusion/categorical.py`: the 'tomask' /
'absorb' / 'uniform' priors; for training the forward noising
`q(v_t | v_0)`, the one-step posterior `q(v_{t-1} | v_t, v_0)` with its
t == 0 override and the KL / decoder-NLL loss split; for sampling prior
draws, the posterior with explicit (possibly multi-step) [K, K] tables,
and the strided table builder. Tables are built on the host in float64 and
used as float32. Every draw takes a `torch.Generator` or the uniform
numbers themselves. `UniformCategoricalTransition` is the reference's
legacy uniform-prior class.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .masked import (categorical_kl, clamped_log, index_to_log_onehot,
                          log_categorical, log_sample_categorical)

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


def build_transition_mats(betas: np.ndarray, num_classes: int,
                          init_prob: Union[str, np.ndarray, None]):
    """Host-side float64 construction of the prior, cumulative Q-bar_t and
    Q_t^T: (prob [K], q_mats [T, K, K], transpose_one_step [T, K, K])."""
    prob = build_init_prob(num_classes, init_prob)
    one_step, q_mats = _one_step_mats(betas, prob)
    return prob, q_mats, np.transpose(one_step, (0, 2, 1))


class CategoricalTransition:
    def __init__(self, betas: np.ndarray, num_classes: int,
                 init_prob: Union[str, np.ndarray, None] = None):
        self.num_classes = num_classes
        prob, cum, transpose_one_step = build_transition_mats(
            np.asarray(betas, np.float64), num_classes, init_prob)
        self.init_logprob = np.clip(np.log(prob + EPS), -32.0, None
                                    ).astype(np.float32)
        # cumulative Q-bar_t and transposed one-step Q_t^T, [T, K, K]
        self.q_mats = cum.astype(np.float32)
        self.transpose_q_onestep = transpose_one_step.astype(np.float32)
        self._dev = {}

    @property
    def num_timesteps(self) -> int:
        return self.q_mats.shape[0]

    def _tables(self, device):
        """(q_mats, transpose_q_onestep) as tensors on `device`, cached."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = (torch.as_tensor(self.q_mats, device=device),
                              torch.as_tensor(self.transpose_q_onestep,
                                              device=device))
        return self._dev[key]

    @staticmethod
    def _mix(p: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
        """out[b, ..., k] = sum_j p[b, ..., j] * mats[b, j, k]."""
        M = mats.reshape(mats.shape[:1] + (1,) * (p.dim() - 2)
                         + mats.shape[1:])
        return (p[..., :, None] * M).sum(-2)

    # ----- forward (noising) -----
    def q_vt_pred(self, log_v0: torch.Tensor, t: torch.Tensor
                  ) -> torch.Tensor:
        """log q(v_t | v_0). log_v0: [B, ..., K], t: [B]."""
        q_mats, _ = self._tables(log_v0.device)
        return clamped_log(self._mix(torch.exp(log_v0), q_mats[t.long()]))

    def q_vt_sample(self, log_v0, t, generator=None, uniform=None):
        log_q = self.q_vt_pred(log_v0, t)
        cls = log_sample_categorical(log_q, generator, uniform)
        return cls, index_to_log_onehot(cls, self.num_classes)

    def add_noise(self, v: torch.Tensor, t: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None):
        """v: [B, ...] int class ids -> (one-hot v_t, log v_t, log v_0)."""
        log_v0 = index_to_log_onehot(v, self.num_classes)
        v_pert, log_vt = self.q_vt_sample(log_v0, t, generator, uniform)
        return self.onehot_encode(v_pert), log_vt, log_v0

    def onehot_encode(self, v: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(v.long(), self.num_classes).to(
            torch.float32)

    # ----- reverse (posterior) -----
    def q_v_posterior(self, log_v0: torch.Tensor, log_vt: torch.Tensor,
                      t: torch.Tensor, v0_prob: bool = True) -> torch.Tensor:
        """log q(v_{t-1} | v_t, v_0); t == 0 entries return log_v0."""
        q_mats, tq = self._tables(log_v0.device)
        t = t.long()
        fact1 = self._mix(torch.exp(log_vt), tq[t])
        fact2_mat = q_mats[torch.clamp(t - 1, min=0)]
        if v0_prob:
            fact2 = self._mix(torch.exp(log_v0), fact2_mat)
        else:
            fact2 = self._mix(self.onehot_encode(log_v0.argmax(-1)),
                              fact2_mat)
        out = clamped_log(fact1) + clamped_log(fact2)
        out = out - torch.logsumexp(out, dim=-1, keepdim=True)
        time_zero = (t == 0).reshape(t.shape + (1,) * (out.dim() - 1))
        return torch.where(time_zero, log_v0, out)

    def compute_v_Lt(self, log_post_true: torch.Tensor,
                     log_post_pred: torch.Tensor, log_v0: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        """Per-entry loss: KL(true || pred), or decoder NLL where t == 0."""
        kl_v = categorical_kl(log_post_true, log_post_pred)
        decoder_nll = -log_categorical(log_v0, log_post_pred)
        mask = (t == 0).to(kl_v.dtype).reshape(
            t.shape + (1,) * (kl_v.dim() - 1))
        return mask * decoder_nll + (1.0 - mask) * kl_v

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

    def sample_init(self, shape, generator: Optional[torch.Generator],
                    device, uniform: Optional[torch.Tensor] = None):
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


def _log1m_exp(log_a: np.ndarray) -> np.ndarray:
    """log(1 - exp(log_a)), stable (host-side float64)."""
    return np.log1p(-np.exp(log_a) + 1e-40)


def _texp(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] -> [B, 1, ..., 1] with `ndim` dims."""
    return x.reshape(x.shape + (1,) * (ndim - 1))


class UniformCategoricalTransition:
    """Log-space uniform-prior categorical diffusion, the reference's
    legacy class (counterpart of the JAX package's class of that name;
    no shipped configuration selects it). Closed-form alpha-bar mixing
    with the uniform distribution instead of per-step matrices:
    q(v_t | v_0) = alpha-bar_t v_0 + (1 - alpha-bar_t) / K."""

    def __init__(self, betas: np.ndarray, num_classes: int):
        betas = np.asarray(betas, np.float64)
        log_alphas = np.log(1.0 - betas)
        log_alphas_bar = np.cumsum(log_alphas)
        f32 = lambda a: np.asarray(a, np.float32)
        self.log_alphas = f32(log_alphas)
        self.log_1m_alphas = f32(_log1m_exp(log_alphas))
        self.log_alphas_bar = f32(log_alphas_bar)
        self.log_1m_alphas_bar = f32(_log1m_exp(log_alphas_bar))
        self.num_classes = num_classes

    def _mix(self, log_v, t, log_a, log_1m_a):
        la = _texp(torch.as_tensor(log_a, device=log_v.device)[t.long()],
                   log_v.dim())
        l1a = _texp(torch.as_tensor(log_1m_a, device=log_v.device)[t.long()],
                    log_v.dim())
        return torch.logaddexp(log_v + la,
                               l1a - float(np.log(self.num_classes)))

    def q_vt_pred(self, log_v0: torch.Tensor, t: torch.Tensor
                  ) -> torch.Tensor:
        return self._mix(log_v0, t, self.log_alphas_bar,
                         self.log_1m_alphas_bar)

    def q_v_pred_one_timestep(self, log_vt: torch.Tensor, t: torch.Tensor
                              ) -> torch.Tensor:
        return self._mix(log_vt, t, self.log_alphas, self.log_1m_alphas)

    def add_noise(self, v: torch.Tensor, t: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None):
        """v: [B, ...] class ids -> (one-hot v_t, log v_t, log v_0)."""
        log_v0 = index_to_log_onehot(v, self.num_classes)
        v_pert = log_sample_categorical(self.q_vt_pred(log_v0, t), generator,
                                        uniform)
        return (self.onehot_encode(v_pert),
                index_to_log_onehot(v_pert, self.num_classes), log_v0)

    def onehot_encode(self, v: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.one_hot(v.long(), self.num_classes).to(
            torch.float32)

    def q_v_posterior(self, log_v0: torch.Tensor, log_vt: torch.Tensor,
                      t: torch.Tensor, v0_prob: bool = True) -> torch.Tensor:
        """log q(v_{t-1} | v_t, v_0); v0_prob=False hardens log_v0 to its
        argmax one-hot first; t == 0 mixes from log_v0 itself."""
        if not v0_prob:
            log_v0 = clamped_log(self.onehot_encode(log_v0.argmax(-1)))
        t = t.long()
        log_qvtmin = self.q_vt_pred(log_v0, torch.clamp(t - 1, min=0))
        log_qvtmin = torch.where(_texp(t == 0, log_v0.dim()), log_v0,
                                 log_qvtmin)
        unnormed = log_qvtmin + self.q_v_pred_one_timestep(log_vt, t)
        return unnormed - torch.logsumexp(unnormed, dim=-1, keepdim=True)

    def compute_v_Lt(self, log_post_true, log_post_pred, log_v0, t):
        kl_v = categorical_kl(log_post_true, log_post_pred)
        decoder_nll = -log_categorical(log_v0, log_post_pred)
        mask = _texp((t == 0).to(kl_v.dtype), kl_v.dim())
        return mask * decoder_nll + (1.0 - mask) * kl_v

    def sample_init(self, shape, generator: Optional[torch.Generator],
                    device, uniform: Optional[torch.Tensor] = None):
        """v_T uniform over the classes -> (ids, one-hot, log one-hot)."""
        logits = torch.zeros(tuple(shape) + (self.num_classes,),
                             device=device)
        init_types = log_sample_categorical(logits, generator, uniform)
        return (init_types, self.onehot_encode(init_types),
                index_to_log_onehot(init_types, self.num_classes))
