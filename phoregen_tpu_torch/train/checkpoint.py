"""Checkpoint save/load with last/best, resume and warm-start semantics.

Counterpart of `phoregen_tpu/train/checkpoint.py`, in the same format: the
array state as the msgpack bytes of flax's serialization (written and read
by `utils/checkpoint.py`, with no flax) plus a JSON sidecar for epoch, lr
and config. `params` and `ema_params` are flax parameter trees, the Adam
moments sit where optax keeps them (`opt_state/inner_state/0/{count, mu,
nu}`; under `train.freeze_pos` inside optax's masked wrappers, frozen
leaves as empty nodes), and the grad-norm queue and step as the JAX
package's TrainState names them. So the port's sample CLI and the JAX
package's `load_params_only` read a checkpoint the port trained, and the
port resumes from either package's checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.checkpoint import (flatten_tree, from_jax_params,
                                msgpack_restore, msgpack_serialize,
                                strip_collections, to_jax_params)
from .state import (GradNormQueue, TrainState, get_learning_rate,
                    is_frozen_pos_name, set_learning_rate, trained_names)


def _params_tree(named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {"params": to_jax_params(named)}


def _opt_state_tree(state: TrainState, tcfg) -> Dict[str, Any]:
    """The optimizer's moments in optax's layout for `make_optimizer`'s
    chain (inject_hyperparams around adam / adamw)."""
    named = dict(state.net.named_parameters())
    opt = state.optimizer
    mu, nu = {}, {}
    count = 0
    for name in trained_names(state.net, tcfg.freeze_pos):
        st = opt.state.get(named[name], {})
        zeros = torch.zeros_like(named[name])
        mu[name] = st.get("exp_avg", zeros)
        nu[name] = st.get("exp_avg_sq", zeros)
        count = max(count, int(st.get("step", 0)))
    mu_t, nu_t = to_jax_params(mu), to_jax_params(nu)
    if tcfg.freeze_pos:   # optax.masked leaves an empty node per frozen leaf
        for name in named:
            if is_frozen_pos_name(name):
                for tree in (mu_t, nu_t):
                    *path, leaf = name.split(".")
                    node = tree
                    for k in path:
                        node = node.setdefault(k, {})
                    node[leaf] = {}
    i32 = lambda v: np.asarray(v, np.int32)
    f32 = lambda v: np.asarray(v, np.float32)
    hyper = {"learning_rate": f32(get_learning_rate(opt))}
    inner = {"0": {"count": i32(count), "mu": {"params": mu_t},
                   "nu": {"params": nu_t}}, "1": {}}
    if tcfg.optimizer.type == "adam":
        hyper.update(b1=f32(0.9), b2=f32(0.999), eps=f32(1e-8),
                     eps_root=f32(0.0))
    else:
        inner["2"] = {}
    tree = {"count": i32(count), "hyperparams": dict(sorted(hyper.items())),
            "hyperparams_states": {}, "inner_state": inner}
    if tcfg.freeze_pos:
        tree = {"0": {"inner_state": tree}, "1": {"inner_state": {}}}
    return tree


def state_tree(state: TrainState, tcfg) -> Dict[str, Any]:
    q = state.grad_queue
    return {
        "params": _params_tree(dict(state.net.named_parameters())),
        "opt_state": _opt_state_tree(state, tcfg),
        "ema_params": _params_tree(state.ema_params),
        "grad_queue": {"values": q.values.detach().cpu().numpy(),
                       "count": np.asarray(q.count, np.int32),
                       "head": np.asarray(q.head, np.int32)},
        "step": np.asarray(state.step, np.int32),
    }


def _write(path_prefix: str, tree: Dict[str, Any], meta: Dict[str, Any],
           extra: Optional[Dict[str, Any]]) -> None:
    with open(path_prefix + ".msgpack", "wb") as f:
        f.write(msgpack_serialize(tree))
    if extra:
        meta.update(extra)
    with open(path_prefix + ".json", "w") as f:
        json.dump(meta, f, indent=1, default=str)


def save_checkpoint(path_prefix: str, state: TrainState, epoch: int,
                    config, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write `<prefix>.msgpack` + `<prefix>.json` (`config`: the Config)."""
    _write(path_prefix, state_tree(state, config.train), {
        "epoch": int(epoch), "step": int(state.step),
        "lr": get_learning_rate(state.optimizer),
        "config": config.to_dict()}, extra)


def save_release(path_prefix: str, state: TrainState, config,
                 extra: Optional[Dict[str, Any]] = None,
                 use_ema: bool = False) -> None:
    """Write a params-only release checkpoint (`release: true` sidecar):
    loadable by `load_checkpoint` and the sample CLIs, not resumable."""
    named = state.ema_params if use_ema \
        else dict(state.net.named_parameters())
    _write(path_prefix, {"params": _params_tree(named)}, {
        "release": True, "ema": bool(use_ema), "step": int(state.step),
        "config": config.to_dict()}, extra)


def find_adam_state(opt_tree) -> Optional[Dict[str, Any]]:
    """The {count, mu, nu} node of an optax opt_state tree, wherever the
    chain and masks put it."""
    if not isinstance(opt_tree, dict):
        return None
    if "mu" in opt_tree and "nu" in opt_tree:
        return opt_tree
    for v in opt_tree.values():
        found = find_adam_state(v)
        if found is not None:
            return found
    return None


def from_jax_train_state(tree: Dict[str, Any], state: TrainState) -> None:
    """Fill `state` in place from the state dict of the JAX package's
    TrainState (`msgpack_restore` of a full checkpoint): params, EMA, Adam
    moments (`mu`/`nu`/`count` -> `exp_avg`/`exp_avg_sq`/`step` by the
    parameter name map), grad-norm queue and step."""
    device = next(state.net.parameters()).device
    state.net.load_state_dict(from_jax_params(tree["params"]), strict=True)
    for k, v in from_jax_params(tree["ema_params"]).items():
        state.ema_params[k] = v.to(device)
    adam = find_adam_state(tree.get("opt_state"))
    if adam is not None:
        named = dict(state.net.named_parameters())
        flat = lambda t: {k: v for k, v in flatten_tree(
            strip_collections(t)).items() if not isinstance(v, dict)}
        mu, nu = flat(adam["mu"]), flat(adam["nu"])
        count = float(np.asarray(adam["count"]))
        for name in mu:
            as_t = lambda a: torch.from_numpy(np.array(a, np.float32)
                                              ).to(device)
            state.optimizer.state[named[name]] = {
                "step": torch.tensor(count), "exp_avg": as_t(mu[name]),
                "exp_avg_sq": as_t(nu[name])}
    q = tree["grad_queue"]
    state.grad_queue = GradNormQueue(device, np.array(q["values"]),
                                     int(q["count"]), int(q["head"]))
    state.step = int(np.asarray(tree["step"]))


def load_checkpoint(path_prefix: str, state: TrainState
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Restore `state` (a freshly created one) in place from
    `<prefix>.msgpack`; returns (state, meta). Release checkpoints restore
    the params only."""
    meta = {}
    if os.path.exists(path_prefix + ".json"):
        with open(path_prefix + ".json") as f:
            meta = json.load(f)
    with open(path_prefix + ".msgpack", "rb") as f:
        tree = msgpack_restore(f.read())
    if meta.get("release"):
        load_params_only(path_prefix, state.net, tree)
        return state, meta
    from_jax_train_state(tree, state)
    if "lr" in meta:
        set_learning_rate(state.optimizer, meta["lr"])
    return state, meta


def load_params_only(path_prefix: str, net: torch.nn.Module,
                     tree: Optional[Dict[str, Any]] = None) -> None:
    """Warm start: load only the model params of a checkpoint into `net`."""
    if tree is None:
        with open(path_prefix + ".msgpack", "rb") as f:
            tree = msgpack_restore(f.read())
    net.load_state_dict(from_jax_params(tree["params"]), strict=True)


def prepare_run_dir(run_dir: str, restart: str = "none") -> bool:
    """Run-directory collision policy. Returns True when resuming from an
    existing directory. Modes: none (error if it exists), overwrite,
    backup (copy the old directory aside, then resume), inplace (resume in
    place), finetuning (fresh run, weights loaded separately)."""
    exists = os.path.isdir(run_dir) and os.listdir(run_dir)
    if not exists:
        os.makedirs(run_dir, exist_ok=True)
        return False
    if restart == "none":
        raise FileExistsError(
            f"run dir {run_dir} exists; set logger.restart to "
            "overwrite/backup/inplace/finetuning")
    if restart == "overwrite":
        shutil.rmtree(run_dir)
        os.makedirs(run_dir)
        return False
    if restart == "backup":
        i = 1
        while os.path.isdir(f"{run_dir}.bak{i}"):
            i += 1
        shutil.copytree(run_dir, f"{run_dir}.bak{i}")
        return True
    if restart == "inplace":
        return True
    if restart == "finetuning":
        return False
    raise ValueError(f"unknown restart mode: {restart}")
