"""Shared inputs for the PyTorch-port parity tests: small shapes, numpy
seeds, the same arrays handed to the JAX package and to the port."""
from __future__ import annotations

import numpy as np
import torch

from phoregen_tpu_torch.models.denoiser import layer_param_shapes

# the small stack of tests/test_layer_stack.py::_setup
H, HEADS, WT, L = 16, 2, 8, 3
NP, NL, K, TRIP_K = 6, 8, 4, 3
FE = 93
B = 2


def random_tree(spec, rng, scale=0.3):
    """Numpy params for a {name: shape or sub-dict} spec; LayerNorm scales
    near 1, everything else ~ N(0, scale / sqrt(fan_in))."""
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = random_tree(v, rng, scale)
        elif k == "scale" or k.endswith("ln_scale"):
            out[k] = (1.0 + 0.1 * rng.normal(size=v)).astype(np.float32)
        else:
            fan = v[-2] if len(v) >= 3 else 4
            out[k] = (scale * rng.normal(size=v) / np.sqrt(fan)
                      ).astype(np.float32)
    return out


def layer_tree(seed=0):
    return random_tree(layer_param_shapes(H, HEADS, WT, FE, L),
                       np.random.default_rng(seed))


def stack_inputs(seed=1):
    """Positions, masks, features and kNN tables for B small graphs."""
    rng = np.random.default_rng(seed)
    N = NP + NL
    x = (1.5 * rng.normal(size=(B, N, 3))).astype(np.float32)
    node_mask = np.ones((B, N), bool)
    node_mask[1, NP - 1] = False          # a padded phore slot
    node_mask[1, N - 2:] = False          # two padded ligand slots
    h = rng.normal(size=(B, N, H)).astype(np.float32)
    hb = rng.normal(size=(B, NL, NL, H)).astype(np.float32)
    pn = rng.normal(size=(B, NP, 3)).astype(np.float32)
    pn /= np.linalg.norm(pn, axis=-1, keepdims=True)
    e_w = rng.uniform(0.2, 1.0, size=(B, N, K)).astype(np.float32)
    return dict(x=x, node_mask=node_mask, h=h, hb=hb, phore_norm=pn, e_w=e_w)


def jax_tables(inp):
    """The JAX package's fused-stack tables (batched) and kNN indices."""
    import jax.numpy as jnp
    import jax
    from phoregen_tpu.ops import layer_stack as jls
    from phoregen_tpu.ops.knn import knn_neighbors as jknn

    x = jnp.asarray(inp["x"])
    nm = jnp.asarray(inp["node_mask"])
    nbr_idx, nbr_mask = jknn(x, nm, K)
    N = NP + NL
    is_lig = jnp.concatenate([jnp.zeros(NP), jnp.ones(NL)]).astype(bool)
    src = jnp.take(is_lig, nbr_idx)
    dst = jnp.broadcast_to(is_lig[None, :, None], src.shape)
    etype = 3 - 2 * src.astype(jnp.int32) - dst.astype(jnp.int32)
    edge_type = jax.nn.one_hot(etype, 4, dtype=jnp.float32)
    t = jls.build_block_tables(x, nm, nbr_idx, nbr_mask, NP, TRIP_K)
    t["edge_type"] = edge_type.reshape(B, N * K, 4)
    t["e_w"] = jnp.asarray(inp["e_w"]).reshape(B, N * K, 1)
    t["phore_norm"] = jnp.asarray(inp["phore_norm"])
    return t, np.array(nbr_idx), np.array(nbr_mask), np.array(edge_type)


def port_tables(inp, nbr_idx, nbr_mask, edge_type):
    from phoregen_tpu_torch.ops import layer_stack as pls
    x = torch.from_numpy(inp["x"])
    t = pls.build_block_tables(x, torch.from_numpy(inp["node_mask"]),
                               torch.from_numpy(nbr_idx),
                               torch.from_numpy(nbr_mask), NP, TRIP_K)
    t["edge_type"] = torch.from_numpy(edge_type)
    t["e_w"] = torch.from_numpy(inp["e_w"])
    t["phore_norm"] = torch.from_numpy(inp["phore_norm"])
    return t


def dims():
    from phoregen_tpu_torch.ops.layer_stack import StackDims
    return StackDims(NP=NP, NL=NL, K=K, K8=min(TRIP_K, NL - 1), H=H,
                     heads=HEADS, Wt=WT)


def tree_to_torch(tree):
    return {k: tree_to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.asarray(v)) for k, v in tree.items()}
