"""Training state: optimizer, EMA shadow, and the adaptive grad-norm queue.

Counterpart of `phoregen_tpu/train/state.py`:
- the optimizer factory: Adam, or AdamW with decoupled weight decay, as
  optax computes them (eps 1e-8 added outside the root after the bias
  correction, no amsgrad); `torch.optim.Adam` / `AdamW` are that arithmetic.
  The plateau schedule runs on the host once per epoch and sets the
  learning rate through `set_learning_rate`;
- queue-based adaptive gradient clipping: a length-50 ring of recent
  gradient norms seeded with 3000; the threshold is `1.5*mean + 2*std`
  (population std over the valid entries); the value pushed is
  `min(gnorm, threshold)`. The ring's values live on the device, its count
  and head are host integers (they advance by one a step, whatever the
  data), so a step needs no host read;
- the EMA shadow of the parameters, updated after the optimizer step when
  `train.ema` is set;
- `train.freeze_pos`: the position-update layers (`pos_layer*`) get no
  update and no weight decay, while their gradients still count in the
  clip norm, as with optax's masked zero update.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

QUEUE_LEN = 50
QUEUE_SEED = 3000.0


class GradNormQueue:
    """Fixed-size ring buffer of recent grad norms. `values[0:count]` are
    valid; `head` is the next write slot."""

    def __init__(self, device, values=None, count: int = 1, head: int = 1):
        if values is None:
            values = torch.zeros(QUEUE_LEN, dtype=torch.float32)
            values[0] = QUEUE_SEED
        self.values = torch.as_tensor(values, dtype=torch.float32).to(device)
        self.count = int(count)
        self.head = int(head)

    def stats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, population std) over the valid entries."""
        v = self.values[:max(self.count, 1)]
        mean = v.mean()
        return mean, torch.sqrt(((v - mean) ** 2).mean())

    def push(self, value: torch.Tensor) -> None:
        self.values[self.head % QUEUE_LEN] = value
        self.count = min(self.count + 1, QUEUE_LEN)
        self.head = (self.head + 1) % QUEUE_LEN


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def _scale_(grads: List[torch.Tensor], max_norm, gnorm) -> None:
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)


def clip_by_queue(grads: List[torch.Tensor], queue: GradNormQueue
                  ) -> torch.Tensor:
    """Adaptive clip in place: threshold = 1.5*mean + 2*std of the history;
    pushes the post-clip norm. Returns the pre-clip norm."""
    mean, std = queue.stats()
    max_norm = 1.5 * mean + 2.0 * std
    gnorm = global_norm(grads)
    _scale_(grads, max_norm, gnorm)
    queue.push(torch.minimum(gnorm, max_norm))
    return gnorm


def clip_fixed(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    gnorm = global_norm(grads)
    _scale_(grads, gnorm.new_tensor(max_norm), gnorm)
    return gnorm


def is_frozen_pos_name(name: str) -> bool:
    """True for a parameter under a position-update layer
    (`pos_layer_with_edge` / `pos_layer_with_bond`)."""
    return any(part.startswith("pos_layer") for part in name.split("."))


def trained_names(net: torch.nn.Module, freeze_pos: bool) -> List[str]:
    """Names of the parameters the optimizer updates, in module order."""
    return [n for n, _ in net.named_parameters()
            if not (freeze_pos and is_frozen_pos_name(n))]


def make_optimizer(cfg, net: torch.nn.Module) -> torch.optim.Optimizer:
    """Adam or AdamW over the trained parameters (`cfg`: the TrainConfig)."""
    ocfg = cfg.optimizer
    named = dict(net.named_parameters())
    params = [named[n] for n in trained_names(net, cfg.freeze_pos)]
    if ocfg.type == "adam":
        return torch.optim.Adam(params, lr=ocfg.lr, betas=(0.9, 0.999),
                                eps=1e-8)
    if ocfg.type == "adamw":
        return torch.optim.AdamW(params, lr=ocfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=ocfg.weight_decay)
    raise NotImplementedError(f"Optimizer not supported: {ocfg.type}")


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def ema_update(ema_params: Dict[str, torch.Tensor], net: torch.nn.Module,
               decay: float) -> None:
    """shadow = decay*shadow + (1-decay)*params, in place."""
    named = dict(net.named_parameters())
    shadow = [ema_params[n] for n in named]
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, [p.detach() for p in named.values()],
                        alpha=1.0 - decay)


@dataclasses.dataclass
class TrainState:
    """The network (its parameters are the state's `params`), the
    optimizer with its moments, the EMA shadow by parameter name, the
    grad-norm queue and the step count."""
    net: torch.nn.Module
    optimizer: torch.optim.Optimizer
    ema_params: Dict[str, torch.Tensor]
    grad_queue: GradNormQueue
    step: int = 0


def create_train_state(cfg, net: torch.nn.Module) -> TrainState:
    device = next(net.parameters()).device
    return TrainState(
        net=net, optimizer=make_optimizer(cfg, net),
        ema_params={n: p.detach().clone()
                    for n, p in net.named_parameters()},
        grad_queue=GradNormQueue(device), step=0)
