"""Reference PhoreGen checkpoints (`.pt`) read into the port.

Counterpart of `phoregen_tpu/utils/torch_import.py`. The upstream project
saves `torch.save({'model': state_dict, 'config': <EasyDict>, 'epoch': ...,
...})`. A config object pickled beside the weights makes
`torch.load(weights_only=True)` refuse the file, and unpickling it freely
would run whatever the pickle names. So the file is read with
`torch.load(..., pickle_module=RESTRICTED_PICKLE)`: an unpickler whose
`find_class` hands out torch's tensor rebuild functions (storages are
resolved by torch itself), `collections.OrderedDict`, the builtin
container and scalar types and numpy's array reconstruction, and maps
every other name (`easydict.EasyDict`, `argparse.Namespace`, the
reference's own classes, `os.system`, ...) to an inert `_Stub`.

`map_reference_state` (numpy only, copied from the JAX package) maps the
reference `PhoreDiff` state dict onto the flax-layout parameter tree, and
`utils/checkpoint.py::from_jax_params` carries that tree into the port's
module. Mapping notes:
- torch `nn.Linear.weight` is [out, in] -> flax kernel [in, out]
  (transpose); `nn.LayerNorm.{weight,bias}` -> {scale, bias}.
- reference MLP = Sequential[Linear, LayerNorm, act, Linear] -> the MLP
  tree {Dense_0, LayerNorm_0, Dense_1}.
- module renames: `hk_func` -> `hk` (hv/hq/xk/xv/xq alike),
  `denoiser.base_block.{i}` -> `denoiser.layer_{i}` (or stacked under
  `denoiser.layers.layer` with `scan_layers`).
- the reference `BondUpdateLayer` concatenates [h_bond_kj, r_kj, r_ji,
  ang, h_k, h_j]; the dense triplet mode applies the same first linear
  layer as split products, so its rows are re-blocked onto {hk_kj, hk_ji,
  hk_ang}. Import requires `denoiser.triplet_mode: dense` (the factorized
  and kNN modes have no reference weights).
- GaussianSmearing `offset` buffers are dropped (recomputed statically).
"""
from __future__ import annotations

import builtins
import collections
import pickle
import types
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# builtins a state dict or its metadata is made of; no callable that acts
_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "range", "set", "slice", "str", "tuple"})
_ALLOWED = {
    "torch._utils": frozenset({"_rebuild_tensor", "_rebuild_tensor_v2",
                               "_rebuild_parameter",
                               "_rebuild_parameter_with_state"}),
    "collections": frozenset({"OrderedDict"}),
    "numpy": frozenset({"dtype", "ndarray"}),
    "numpy.core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "numpy._core.multiarray": frozenset({"_reconstruct", "scalar"}),
}


class _Stub:
    """Inert stand-in for every class or function a checkpoint names
    beyond `_ALLOWED`: it records its arguments and state and runs
    nothing."""

    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def __setstate__(self, state):
        self.state = state

    def __setitem__(self, key, value):    # dict subclasses (EasyDict)
        self.__dict__.setdefault("items", {})[key] = value


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in ("builtins", "__builtin__"):   # protocol 2 names
            if name in _BUILTINS:
                return getattr(builtins, name)
        elif name in _ALLOWED.get(module, ()):
            if module == "torch._utils":
                return getattr(torch._utils, name)
            if module == "collections":
                return collections.OrderedDict
            return super().find_class(module, name)
        return _Stub


def _restricted_load(file, **kwargs):
    return _RestrictedUnpickler(file, **kwargs).load()


# a stand-in for the `pickle` module that torch.load accepts
RESTRICTED_PICKLE = types.ModuleType("phoregen_restricted_pickle")
RESTRICTED_PICKLE.Unpickler = _RestrictedUnpickler
RESTRICTED_PICKLE.load = _restricted_load


def read_torch_pt(path: str) -> Any:
    """A `torch.save` file through the restricted unpickler: tensors as
    CPU tensors, every name beyond `_ALLOWED` as a `_Stub`."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=RESTRICTED_PICKLE)


def _to_numpy(v):
    """A tensor as float32/int numpy (bf16 widened to float32, as the JAX
    reader does); anything else unchanged."""
    if not isinstance(v, torch.Tensor):
        return v
    v = v.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    return v.numpy()


# --------------------------------------------------------------------------
# state-dict -> the flax-layout parameter tree (numpy only)
# --------------------------------------------------------------------------

def _mlp(src: Dict[str, np.ndarray], prefix: str, norm: bool = True
         ) -> Dict[str, Any]:
    """Reference MLP (`models/common.py:99-119`) -> our MLP tree."""
    out = {"Dense_0": {"kernel": src[f"{prefix}.net.0.weight"].T,
                       "bias": src[f"{prefix}.net.0.bias"]}}
    if norm:
        out["LayerNorm_0"] = {"scale": src[f"{prefix}.net.1.weight"],
                              "bias": src[f"{prefix}.net.1.bias"]}
        last = 3
    else:
        last = 2
    out["Dense_1"] = {"kernel": src[f"{prefix}.net.{last}.weight"].T,
                      "bias": src[f"{prefix}.net.{last}.bias"]}
    return out


def _linear(src, prefix, bias=True):
    out = {"kernel": src[f"{prefix}.weight"].T}
    if bias:
        out["bias"] = src[f"{prefix}.bias"]
    return out


def _node_update(src, prefix, out_fc: bool) -> Dict[str, Any]:
    tree = {"hk": _mlp(src, f"{prefix}.hk_func"),
            "hv": _mlp(src, f"{prefix}.hv_func"),
            "hq": _mlp(src, f"{prefix}.hq_func")}
    if out_fc:
        tree["node_output"] = _mlp(src, f"{prefix}.node_output")
    return tree


def _pos_update(src, prefix) -> Dict[str, Any]:
    return {"xk": _mlp(src, f"{prefix}.xk_func"),
            "xv": _mlp(src, f"{prefix}.xv_func"),
            "xq": _mlp(src, f"{prefix}.xq_func")}


def _bond_update_dense(src, prefix, hidden: int, include_h_node: bool
                       ) -> Dict[str, Any]:
    """Reference BondUpdateLayer kv kernel rows re-blocked onto our dense
    triplet mode's split first layer. Row layout of `hk_func.net.0.weight.T`
    (reference `models/uni_denoiser.py:146-150`):
    [h_bond_kj (H), r_kj (20), r_ji (20), ang (13), h_k (H), h_j (H)]."""
    H = hidden
    tree: Dict[str, Any] = {}
    for ours, theirs in (("hk", "hk_func"), ("hv", "hv_func")):
        w = src[f"{prefix}.{theirs}.net.0.weight"].T  # [in, H]
        b = src[f"{prefix}.{theirs}.net.0.bias"]
        blocks = [w[:H], w[H:H + 20], w[H + 20:H + 40], w[H + 40:H + 53]]
        if include_h_node:
            blocks += [w[H + 53:2 * H + 53], w[2 * H + 53:]]
            kj = np.concatenate([blocks[0], blocks[1], blocks[4],
                                 blocks[5]], axis=0)
        else:
            kj = np.concatenate([blocks[0], blocks[1]], axis=0)
        tree[f"{ours}_kj"] = {"kernel": kj, "bias": b}
        tree[f"{ours}_ji"] = {"kernel": blocks[2]}
        tree[f"{ours}_ang"] = {"kernel": blocks[3]}
        tree[f"{ours}_ln"] = {
            "scale": src[f"{prefix}.{theirs}.net.1.weight"],
            "bias": src[f"{prefix}.{theirs}.net.1.bias"]}
        tree[f"{ours}_out"] = {
            "kernel": src[f"{prefix}.{theirs}.net.3.weight"].T,
            "bias": src[f"{prefix}.{theirs}.net.3.bias"]}
    tree["hq"] = _mlp(src, f"{prefix}.hq_func")
    return tree


def _attention_layer(src, prefix, hidden: int, x2h_out_fc: bool,
                     include_h_node: bool, direction_match: bool
                     ) -> Dict[str, Any]:
    tree = {
        "lin_node": _linear(src, f"{prefix}.lin_node"),
        "node_layer_with_edge": _node_update(
            src, f"{prefix}.node_layer_with_edge", x2h_out_fc),
        "node_layer_with_bond": _node_update(
            src, f"{prefix}.node_layer_with_bond", x2h_out_fc),
        "bond_layer": _bond_update_dense(
            src, f"{prefix}.bond_layer", hidden, include_h_node),
        "pos_layer_with_edge": _pos_update(
            src, f"{prefix}.pos_layer_with_edge"),
        "pos_layer_with_bond": _pos_update(
            src, f"{prefix}.pos_layer_with_bond"),
    }
    if direction_match:
        tree["dire_embedding"] = _linear(src, f"{prefix}.dire_embedding")
    return tree


def map_reference_state(state: Dict[str, np.ndarray], cfg) -> Dict[str, Any]:
    """Reference `PhoreDiff.state_dict()` -> `{'params': ...}` for
    `PhoreDiffNet` (requires `denoiser.triplet_mode == 'dense'`)."""
    m = cfg.model
    dn = m.denoiser
    if dn.triplet_mode != "dense":
        raise ValueError(
            "reference checkpoints parameterize the full-width triplet MLPs; "
            "set model.denoiser.triplet_mode='dense' to import "
            f"(got {dn.triplet_mode!r})")
    src = _TrackingDict({k: v for k, v in state.items()
                         if isinstance(v, np.ndarray)})
    H = m.hidden_dim

    p: Dict[str, Any] = {
        "node_embedder": _linear(src, "node_embedder", bias=False),
        "edge_embedder": _linear(src, "edge_embedder", bias=False),
        "phore_embedding": _linear(src, "phore_embedding"),
        "v_inference_0": _linear(src, "v_inference.0"),
        "v_inference_2": _linear(src, "v_inference.2"),
        "atom_mlp_0": _linear(src, "atom_mlp.0"),
        "atom_mlp_2": _linear(src, "atom_mlp.2"),
        "atom_mlp_1_0": _linear(src, "atom_mlp_1.0"),
        "atom_mlp_1_2": _linear(src, "atom_mlp_1.2"),
    }
    if m.bond_diffusion:
        p["bond_inference_0"] = _linear(src, "bond_inference.0")
        p["bond_inference_2"] = _linear(src, "bond_inference.2")
    if m.hp_emb_with_pos:
        p["phore_encoder"] = _node_update(src, "phore_encoder",
                                          out_fc=False)

    layers: List[Dict[str, Any]] = []
    i = 0
    while f"denoiser.base_block.{i}.lin_node.weight" in src:
        layers.append(_attention_layer(
            src, f"denoiser.base_block.{i}", H, dn.x2h_out_fc,
            dn.h_node_in_bond_net, dn.direction_match))
        i += 1
    if i != dn.num_layers:
        raise ValueError(f"checkpoint has {i} denoiser layers, config "
                         f"expects {dn.num_layers}")
    den: Dict[str, Any] = {}
    if dn.scan_layers:
        den["layers"] = {"layer": _stack_trees(layers)}
    else:
        for j, lt in enumerate(layers):
            den[f"layer_{j}"] = lt
    if dn.use_global_ew:
        den["edge_pred_layer"] = _mlp(src, "denoiser.edge_pred_layer")
    p["denoiser"] = den

    # every checkpoint tensor must have been consumed (smearing-offset
    # buffers excluded: those are recomputed statically) — genuinely
    # missing tensors already raised KeyError above
    unused = [k for k in src.unconsumed() if not k.endswith(".offset")]
    if unused:
        raise ValueError(
            f"{len(unused)} checkpoint tensors were not mapped (structure "
            f"mismatch with this config); first: {unused[:5]}")
    return {"params": p}


class _TrackingDict(dict):
    """Dict recording which keys were read (import completeness check)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._seen = set()

    def __getitem__(self, k):
        self._seen.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):
        self._seen.add(k)
        return super().__contains__(k)

    def unconsumed(self):
        return [k for k in self if k not in self._seen]


def _stack_trees(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k in trees[0]:
        vals = [t[k] for t in trees]
        if isinstance(vals[0], dict):
            out[k] = _stack_trees(vals)
        else:
            out[k] = np.stack(vals)
    return out


def load_reference_checkpoint(path: str, cfg) -> Tuple[Dict[str, Any],
                                                       Dict[str, Any]]:
    """`.pt` file -> ({'params': ...} flax-layout numpy tree, metadata).
    Accepts a full training checkpoint ({'model': state_dict, 'epoch':
    ..., ...}: `epoch` and `best_loss` go into the metadata) and a bare
    state dict; a DataParallel `module.` prefix is stripped."""
    obj = read_torch_pt(path)
    meta: Dict[str, Any] = {}
    state = obj
    if isinstance(state, dict) and "model" in state \
            and not any("." in k for k in state if isinstance(k, str)):
        meta = {k: v for k, v in state.items()
                if k in ("epoch", "best_loss")}
        state = state["model"]
    if not isinstance(state, dict):
        raise ValueError(f"{path}: unexpected checkpoint structure "
                         f"({type(state).__name__})")
    state = {(k[7:] if isinstance(k, str) and k.startswith("module.")
              else k): _to_numpy(v) for k, v in state.items()}
    return map_reference_state(state, cfg), meta
