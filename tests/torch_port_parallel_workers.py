"""Rank bodies for tests/test_torch_port_parallel.py. They run in spawned
processes (`parallel.group.launch`), so this module imports torch and the
port only: no JAX, and no test module that imports it."""
from __future__ import annotations

import os

import numpy as np
import torch

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.parallel import group
from phoregen_tpu_torch.train import state as pstate
from phoregen_tpu_torch.train.checkpoint import (from_jax_train_state,
                                                 load_checkpoint,
                                                 save_checkpoint,
                                                 state_tree)
from phoregen_tpu_torch.train.step import make_eval_step, make_train_step


def _join(rank, world, init_method):
    torch.set_num_threads(1)
    group.init(rank, world, init_method, torch.device("cpu"))


def snapshot(st) -> dict:
    """Everything a train state holds, as numpy, by name."""
    out = {"params/" + n: p.detach().numpy().copy()
           for n, p in st.net.named_parameters()}
    out.update({"ema/" + n: v.numpy().copy()
                for n, v in st.ema_params.items()})
    out["queue"] = st.grad_queue.values.numpy().copy()
    out["queue_count"] = np.asarray(st.grad_queue.count)
    out["step"] = np.asarray(st.step)
    for i, p in enumerate(st.net.parameters()):
        for k, v in st.optimizer.state.get(p, {}).items():
            out[f"opt/{i}/{k}"] = v.numpy().copy()
    return out


def _rows(tree: dict, rows: slice) -> dict:
    return {k: v[rows] for k, v in tree.items()}


def train_steps(rank, world, init_method, cfg_dict, jax_state, batch,
                seeds, draws):
    """Steps of the port's train step from the JAX TrainState `jax_state`
    on this rank's rows of the global `batch` and of each step's `draws`
    (numpy, global); then one eval step. Returns the metrics of every
    step (floats) and the final state."""
    _join(rank, world, init_method)
    try:
        cfg = config_from_dict(cfg_dict)
        pg = PhoreGen(cfg)
        st = pstate.create_train_state(cfg.train, pg.net)
        from_jax_train_state(jax_state, st)
        rows = group.local_batch_slice(len(batch["lig_type"]))
        tb = PhoreGraphBatch(**_rows(batch, rows)).to("cpu")
        step = make_train_step(pg, cfg)
        metrics = []
        for seed, d in zip(seeds, draws):
            m = step(st, seed, tb, **{k: torch.from_numpy(v)
                                      for k, v in _rows(d, rows).items()})
            metrics.append({k: float(v) for k, v in m.items()})
        gm = (np.arange(len(batch["lig_type"])) % 3 != 1)[rows]
        ev = make_eval_step(pg, cfg)(5, tb, torch.from_numpy(gm),
                                     t=torch.from_numpy(draws[0]["t"][rows]))
        return {"metrics": metrics, "eval": {k: float(v)
                                             for k, v in ev.items()},
                "state": snapshot(st)}
    finally:
        group.shutdown()


def checkpoint_round(rank, world, init_method, cfg_dict, load_from,
                     save_to, batch, seed):
    """Read the checkpoint `load_from` on every rank (a fresh state when
    None), check the ranks hold the same state, take one train step on
    this rank's rows, and let rank 0 write `save_to`. Returns the state
    as read and as written."""
    _join(rank, world, init_method)
    try:
        cfg = config_from_dict(cfg_dict)
        pg = PhoreGen(cfg)
        from phoregen_tpu_torch.models.phoregen import init_params
        init_params(pg.net, cfg.train.seed)
        st = pstate.create_train_state(cfg.train, pg.net)
        if load_from is not None:
            st, _ = load_checkpoint(load_from, st)
        read = snapshot(st)
        rows = group.local_batch_slice(len(batch["lig_type"]))
        tb = PhoreGraphBatch(**_rows(batch, rows)).to("cpu")
        make_train_step(pg, cfg)(st, seed, tb)
        if group.rank() == 0:
            save_checkpoint(save_to, st, 0, cfg)
        group.barrier()
        return {"read": read, "written": snapshot(st),
                "tree_keys": sorted(state_tree(st, cfg.train))}
    finally:
        group.shutdown()


def run_train(rank, world, init_method, cfg_dict, run_dir, train, valid,
              epochs):
    """`Run.train` on this rank's device (the CPU) in a process group."""
    _join(rank, world, init_method)
    try:
        from phoregen_tpu_torch.train.loop import Run
        cfg = config_from_dict(cfg_dict)
        run = Run(cfg, run_dir=run_dir, device="cpu")
        history = run.train(train, valid, epochs=epochs)
        return {"history": history,
                "files": sorted(os.listdir(run_dir)),
                "state": snapshot(run.state)}
    finally:
        group.shutdown()
