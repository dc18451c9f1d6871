"""Train and eval steps, on one device or data-parallel over ranks.

Counterpart of `phoregen_tpu/train/step.py`: ligand coordinate jitter,
`compute_loss`, backward, adaptive clip, optimizer step, (optional) EMA.
The step's randomness comes from a `torch.Generator` on the batch's
device, seeded with the step's host-scalar seed.

In a process group (`parallel/group.py`) `batch` is this rank's rows of
the global batch, and the step computes what one process computes on the
global batch, as the JAX step does over its `data` mesh:
- the draws are the global batch's, each rank keeping its rows
  (`ops/draws.BatchRows`), so no two graphs share a stream;
- the loss is the global one: every sum it divides (valid atoms, bonds,
  graphs) is summed over the ranks before the division
  (`PhoreGen.loss_from_perturbation(sum_over_ranks=)`), never a mean of
  per-rank means;
- the gradients are summed over the ranks after the backward
  (`group.reduce_gradients`), so the clip queue, the optimizer and the
  EMA see the global gradient and stay identical on every rank;
- the metrics, and the eval step's `graph_mask` means, are the global
  batch's on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from ..ops.draws import BatchRows
from ..parallel import group
from .state import TrainState, clip_by_queue, clip_fixed, ema_update


def _generator(seed, device, rows: int):
    """The step's generator; in a process group, this rank's `rows` of
    the global batch's draws."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = group.world_size()
    if n == 1:
        return gen
    r = group.rank()
    return BatchRows(gen, r * rows, (r + 1) * rows, n * rows)


def _reduction():
    return group.sum_over_ranks if group.is_initialized() else None


def make_train_step(pg, cfg) -> Callable:
    """Build the train step: (state, seed, batch, **draws) -> metrics, with
    `state` updated in place. `seed` is the step's host-scalar seed;
    `draws` inject `PhoreGen.perturb`'s random numbers for this rank's
    rows instead. Metrics are tensors on the device (no host read here)."""
    tcfg = cfg.train
    lig_noise_std = tcfg.lig_noise_std if tcfg.add_lig_noise else 0.0

    def step(state: TrainState, seed, batch, **draws
             ) -> Dict[str, torch.Tensor]:
        params = list(state.net.parameters())
        state.net.zero_grad(set_to_none=True)
        gen = _generator(seed, batch.lig_pos.device, batch.num_graphs)
        with record_function("train.forward"):
            loss, metrics = pg.compute_loss(
                batch, gen, lig_noise_std=lig_noise_std,
                compute_dtype=tcfg.dtype, sum_over_ranks=_reduction(),
                **draws)
        with record_function("train.backward"):
            loss.backward()
            group.reduce_gradients(params)
        with record_function("train.clip"):
            # the clip norm runs over ALL gradients, frozen leaves included
            grads = [p.grad for p in params if p.grad is not None]
            if tcfg.clip_grad and tcfg.clip_grad_mode == "queue":
                gnorm = clip_by_queue(grads, state.grad_queue)
            elif tcfg.clip_grad:
                gnorm = clip_fixed(grads, tcfg.max_grad_norm)
            else:
                gnorm = loss.new_zeros(())
        with record_function("train.adam"):
            state.optimizer.step()
        if tcfg.ema:
            with record_function("train.ema"):
                ema_update(state.ema_params, state.net, tcfg.ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return step


def make_eval_step(pg, cfg) -> Callable:
    """Validation step: (seed, batch, graph_mask=None) -> metrics on the
    network's current parameters; no grad, no coordinate jitter.
    `graph_mask` [B] (this rank's rows) excludes the cycled duplicates of
    a tail batch from every reduction."""

    def step(seed, batch, graph_mask: Optional[torch.Tensor] = None,
             **draws) -> Dict[str, torch.Tensor]:
        gen = _generator(seed, batch.lig_pos.device, batch.num_graphs)
        with torch.no_grad():
            _, metrics = pg.compute_loss(
                batch, gen, lig_noise_std=0.0, compute_dtype=cfg.train.dtype,
                graph_mask=graph_mask, sum_over_ranks=_reduction(), **draws)
        return metrics

    return step
