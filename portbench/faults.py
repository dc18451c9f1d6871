"""Faults planted in the program's timed path, for the tests that see
`correct` come out false and for the fault readings of a training cell's
limits (`python3 -m portbench.control --fault <name>`):

- `unchanged`: a step that returns its state unchanged;
- `half`: half of the batch left out (sampling: the second half of the
  pool keeps its state; training: the step runs on the first half, its
  means taken over it);
- `token` (sampling): one sampled atom class altered where it is drawn;
- `answer` (training): the loss altered by 5% where it is formed.

No cell spans chips, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

SAMPLING = ("unchanged", "half", "token")
TRAINING = ("unchanged", "half", "answer")


def _sampling_step(orig, fault: str):
    def step(self, state, i, batch, inv, is_final, generator=None,
             draws=None):
        new, preds = orig(self, state, i, batch, inv, is_final, generator,
                          draws)
        if fault == "unchanged":
            return state, preds
        if fault == "half":
            h = state["pos"].shape[0] // 2
            return {k: None if v is None else torch.cat([v[:h],
                                                         state[k][h:]])
                    for k, v in new.items()}, preds
        node = new["node"].clone()
        node[0, 0] = (node[0, 0] + 1) % new["log_node"].shape[-1]
        return dict(new, node=node), preds
    return step


def _train_step(run_step, fault: str):
    def step(state, seed, batch, **draws):
        if fault == "unchanged":
            before = {n: p.detach().clone()
                      for n, p in state.net.named_parameters()}
            m = run_step(state, seed, batch, **draws)
            with torch.no_grad():
                for n, p in state.net.named_parameters():
                    p.copy_(before[n])
            return m
        if fault == "half":
            h = batch.lig_mask.shape[0] // 2
            half = type(batch)(**{f.name: getattr(batch, f.name)[:h]
                                  for f in dataclasses.fields(batch)})
            return run_step(state, seed, half,
                            **{k: v[:h] for k, v in draws.items()})
        from phoregen_tpu_torch.models.phoregen import PhoreGen
        orig = PhoreGen.loss_from_perturbation

        def altered(self, *a, **k):
            loss, metrics = orig(self, *a, **k)
            return loss * 1.05, dict(metrics, loss=loss * 1.05)
        PhoreGen.loss_from_perturbation = altered
        try:
            return run_step(state, seed, batch, **draws)
        finally:
            PhoreGen.loss_from_perturbation = orig
    return step


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Within the block, the program's sampling step (`kind`
    'sample_pools') or train step ('finetune') carries `fault`."""
    if kind == "sample_pools":
        from phoregen_tpu_torch.sample.sampler import Sampler
        if fault not in SAMPLING:
            raise ValueError(f"sampling fault {fault!r}")
        orig = Sampler.step
        Sampler.step = _sampling_step(orig, fault)
        try:
            yield
        finally:
            Sampler.step = orig
        return
    from phoregen_tpu_torch.train import loop
    if fault not in TRAINING:
        raise ValueError(f"training fault {fault!r}")
    orig_init = loop.Run.init_state

    def init_state(self):
        st = orig_init(self)
        self.train_step = _train_step(self.train_step, fault)
        return st
    loop.Run.init_state = init_state
    try:
        yield
    finally:
        loop.Run.init_state = orig_init
