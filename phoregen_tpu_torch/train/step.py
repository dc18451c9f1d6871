"""Train and eval steps on one device.

Counterpart of `phoregen_tpu/train/step.py`: ligand coordinate jitter,
`compute_loss`, backward, adaptive clip, optimizer step, (optional) EMA.
The step's randomness comes from a `torch.Generator` on the batch's
device, seeded with the step's host-scalar seed. Data-parallel training
over several cards is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .state import TrainState, clip_by_queue, clip_fixed, ema_update


def _single_device(cfg, mesh) -> None:
    if mesh is not None or cfg.train.num_devices > 1:
        raise NotImplementedError(
            "data-parallel training (mesh / train.num_devices > 1) is not "
            "ported yet: ROADMAP.md, 'Still to port', multi-GPU")


def _generator(seed, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_train_step(pg, cfg, mesh=None) -> Callable:
    """Build the train step: (state, seed, batch, **draws) -> metrics, with
    `state` updated in place. `seed` is the step's host-scalar seed;
    `draws` inject `PhoreGen.perturb`'s random numbers instead. Metrics
    are tensors on the device (no host read here)."""
    _single_device(cfg, mesh)
    tcfg = cfg.train
    lig_noise_std = tcfg.lig_noise_std if tcfg.add_lig_noise else 0.0

    def step(state: TrainState, seed, batch, **draws
             ) -> Dict[str, torch.Tensor]:
        params = list(state.net.parameters())
        state.net.zero_grad(set_to_none=True)
        gen = _generator(seed, batch.lig_pos.device)
        loss, metrics = pg.compute_loss(
            batch, gen, lig_noise_std=lig_noise_std,
            compute_dtype=tcfg.dtype, **draws)
        loss.backward()
        # the clip norm runs over ALL gradients, frozen leaves included
        grads = [p.grad for p in params if p.grad is not None]
        if tcfg.clip_grad and tcfg.clip_grad_mode == "queue":
            gnorm = clip_by_queue(grads, state.grad_queue)
        elif tcfg.clip_grad:
            gnorm = clip_fixed(grads, tcfg.max_grad_norm)
        else:
            gnorm = loss.new_zeros(())
        state.optimizer.step()
        if tcfg.ema:
            ema_update(state.ema_params, state.net, tcfg.ema_decay)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        return metrics

    return step


def make_eval_step(pg, cfg, mesh=None) -> Callable:
    """Validation step: (seed, batch, graph_mask=None) -> metrics on the
    network's current parameters; no grad, no coordinate jitter.
    `graph_mask` [B] excludes the cycled duplicates of a tail batch from
    every reduction."""
    _single_device(cfg, mesh)

    def step(seed, batch, graph_mask: Optional[torch.Tensor] = None,
             **draws) -> Dict[str, torch.Tensor]:
        gen = _generator(seed, batch.lig_pos.device)
        with torch.no_grad():
            _, metrics = pg.compute_loss(
                batch, gen, lig_noise_std=0.0, compute_dtype=cfg.train.dtype,
                graph_mask=graph_mask, **draws)
        return metrics

    return step
