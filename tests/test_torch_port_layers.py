"""The port's attention layers (`models/layers.py`) and neighbour tables
(`ops/knn.py`) against the JAX package's flax modules, on the same numpy
parameters and inputs: B=2 graphs, NP=4 phore + NL=8 ligand slots, H=32,
4 heads, triplet width 8, padded slots in graph 1.

The numpy parameter tree is drawn over the port's own shape spec and handed
to flax as `{"params": tree}`, so a spec that differs from what the flax
module declares fails the apply. Tolerance atol = rtol = 1e-5: the same
float32 arithmetic, only summation order differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.models import layers as jl
from phoregen_tpu.ops import knn as jknn

from phoregen_tpu_torch.models import layers as pl
from phoregen_tpu_torch.ops import knn as pknn

import torch_port_common as C

TOL = dict(atol=1e-5, rtol=1e-5)
B, NP, NL, H, HEADS, WT, K = 2, 4, 8, 32, 4, 8, 5
N = NP + NL
FE = 13


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (1.5 * rng.normal(size=(B, N, 3))).astype(f)
    mask = np.ones((B, N), bool)
    mask[1, NP - 1] = False
    mask[1, N - 2:] = False
    nbr_idx, nbr_mask = jknn.knn_neighbors(jnp.asarray(x), jnp.asarray(mask),
                                           K)
    mask_l = mask[:, NP:]
    pair = mask_l[:, :, None] & mask_l[:, None, :] & ~np.eye(NL, dtype=bool)
    return dict(
        x=x, mask=mask, mask_l=mask_l, pair=pair,
        h=rng.normal(size=(B, N, H)).astype(f),
        hb=rng.normal(size=(B, NL, NL, H)).astype(f),
        ef=rng.normal(size=(B, N, K, FE)).astype(f),
        e_w=rng.uniform(0.2, 1.0, size=(B, N, K)).astype(f),
        nbr_idx=np.array(nbr_idx), nbr_mask=np.array(nbr_mask))


def _params(spec, seed=1):
    tree = C.random_tree(spec, np.random.default_rng(seed))
    return {"params": tree}, C.tree_to_torch(tree)


T = torch.from_numpy
KW = dict(hidden_dim=H, n_heads=HEADS)


@pytest.mark.parametrize("style", ["split", "concat"])
@pytest.mark.parametrize("out_fc", [False, True])
def test_node_update_knn_matches_flax(style, out_fc):
    i = _inputs()
    jp, pp = _params(pl.NodeUpdateKNN.shapes(FE, H, True, out_fc))
    ref = jl.NodeUpdateKNN(out_fc=out_fc, apply_style=style, **KW).apply(
        jp, i["h"], i["ef"], i["nbr_idx"], i["nbr_mask"], i["e_w"])
    out = pl.NodeUpdateKNN(out_fc=out_fc, apply_style=style, **KW)(
        pp, T(i["h"]), T(i["ef"]), T(i["nbr_idx"]), T(i["nbr_mask"]),
        T(i["e_w"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("style", ["split", "concat"])
@pytest.mark.parametrize("norm", [True, False])
def test_node_update_dense_matches_flax(style, norm):
    i = _inputs()
    h_l = i["h"][:, NP:]
    jp, pp = _params(pl.NodeUpdateDense.shapes(H, H, norm))
    ref = jl.NodeUpdateDense(norm=norm, apply_style=style, **KW).apply(
        jp, h_l, i["hb"], i["pair"])
    out = pl.NodeUpdateDense(norm=norm, apply_style=style, **KW)(
        pp, T(h_l), T(i["hb"]), T(i["pair"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("style", ["split", "concat"])
def test_pos_update_knn_matches_flax(style):
    i = _inputs()
    rel = i["x"][:, :, None, :] - np.take_along_axis(
        i["x"][:, None], i["nbr_idx"][..., None], 2)
    jp, pp = _params(pl.PosUpdateKNN.shapes(FE, H, HEADS))
    ref = jl.PosUpdateKNN(apply_style=style, act_fn="silu", **KW).apply(
        jp, i["h"], rel, i["ef"], i["nbr_idx"], i["nbr_mask"], i["e_w"])
    out = pl.PosUpdateKNN(apply_style=style, act_fn="silu", **KW)(
        pp, T(i["h"]), T(rel), T(i["ef"]), T(i["nbr_idx"]),
        T(i["nbr_mask"]), T(i["e_w"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("style", ["split", "concat"])
def test_pos_update_dense_matches_flax(style):
    i = _inputs()
    h_l, pos_l = i["h"][:, NP:], i["x"][:, NP:]
    rel = pos_l[:, None, :, :] - pos_l[:, :, None, :]
    jp, pp = _params(pl.PosUpdateDense.shapes(H, H, HEADS))
    ref = jl.PosUpdateDense(apply_style=style, **KW).apply(
        jp, h_l, rel, i["hb"], i["pair"])
    out = pl.PosUpdateDense(apply_style=style, **KW)(
        pp, T(h_l), T(rel), T(i["hb"]), T(i["pair"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


BOND_CASES = {
    # factorized over the knn_k nearest sources of j (_pool_knn)
    "knn_split": dict(knn_k=3),
    "knn_concat": dict(knn_k=3, apply_style="concat"),
    # factorized over all k (ops/pallas_triplet.py::triplet_pool)
    "allk_split": dict(knn_k=0),
    "allk_concat": dict(knn_k=0, apply_style="concat"),
    "allk_by_wide_knn": dict(knn_k=NL - 1),
    "allk_use_pallas": dict(knn_k=0, use_pallas=True),
    "allk_no_h_node_no_norm": dict(knn_k=0, include_h_node=False,
                                   norm=False),
    "dense": dict(mode="dense"),
    "dense_no_h_node": dict(mode="dense", include_h_node=False),
}


@pytest.mark.parametrize("case", sorted(BOND_CASES))
def test_bond_update_triplet_matches_flax(case):
    kw = dict(width=WT, **BOND_CASES[case])
    i = _inputs()
    h_l, pos_l = i["h"][:, NP:], i["x"][:, NP:]
    jp, pp = _params(pl.BondUpdateTriplet.shapes(
        H, HEADS, kw.get("norm", True), kw.get("include_h_node", True), 3,
        kw.get("mode", "factorized"), WT))
    ref = jl.BondUpdateTriplet(**KW, **kw).apply(
        jp, h_l, i["hb"], pos_l, i["mask_l"])
    out = pl.BondUpdateTriplet(**KW, **kw)(
        pp, T(h_l), T(i["hb"]), T(pos_l), T(i["mask_l"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bond_update_triplet_frozen_table_matches_flax():
    i = _inputs()
    h_l, pos_l = i["h"][:, NP:], i["x"][:, NP:]
    # a table built at other positions than the ones the layer sees
    idx, m = jknn.knn_neighbors(jnp.asarray(pos_l[:, ::-1].copy()),
                                jnp.asarray(i["mask_l"]), 3)
    jp, pp = _params(pl.BondUpdateTriplet.shapes(H, HEADS, width=WT))
    ref = jl.BondUpdateTriplet(width=WT, knn_k=3, **KW).apply(
        jp, h_l, i["hb"], pos_l, i["mask_l"], trip_frozen=(idx, m))
    out = pl.BondUpdateTriplet(width=WT, knn_k=3, **KW)(
        pp, T(h_l), T(i["hb"]), T(pos_l), T(i["mask_l"]),
        trip_frozen=(T(np.array(idx)), T(np.array(m))))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# ----------------------------------------------------------- neighbours

def _tied_points(seed=3):
    """Duplicated points and an exact lattice: many exact distance ties."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, size=(B, N, 3)).astype(np.float32)
    mask = np.ones((B, N), bool)
    mask[0, 2] = False
    mask[1, N - 3:] = False
    return x, mask


@pytest.mark.parametrize("points", ["random", "tied"])
def test_knn_neighbors_match_jax_including_ties(points):
    if points == "tied":
        x, mask = _tied_points()
    else:
        i = _inputs(2)
        x, mask = i["x"], i["mask"]
    for k in (3, N + 4):                       # the second clamps to N-1
        ji, jm = jknn.knn_neighbors(jnp.asarray(x), jnp.asarray(mask), k)
        pi, pm = pknn.knn_neighbors(T(x), T(mask), k)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("points", ["random", "tied"])
def test_radius_neighbors_match_jax(points):
    x, mask = _tied_points() if points == "tied" else (
        _inputs(2)["x"], _inputs(2)["mask"])
    r = 1.0 if points == "tied" else 2.0
    ji, jm = jknn.radius_neighbors(jnp.asarray(x), jnp.asarray(mask), 4, r)
    pi, pm = pknn.radius_neighbors(T(x), T(mask), 4, r)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert 0 < pm.sum() < pm.numel()


@pytest.mark.parametrize("points", ["random", "tied"])
def test_knn_neighbors_return_d2_matches_jax(points):
    """`return_d2` adds the masked squared distances: 1e-6 relative on the
    finite entries, the same pattern of the +inf fill (padding and the
    diagonal), and the same table as without it."""
    x, mask = _tied_points() if points == "tied" else (
        _inputs(2)["x"], _inputs(2)["mask"])
    ji, jm, jd2 = jknn.knn_neighbors(jnp.asarray(x), jnp.asarray(mask), 4,
                                     return_d2=True)
    pi, pm, pd2 = pknn.knn_neighbors(T(x), T(mask), 4, return_d2=True)
    jd2, pd2 = np.asarray(jd2), pd2.numpy()
    assert pd2.shape == jd2.shape == (B, N, N)
    inf = jd2 >= 0.5 * jknn._INF
    np.testing.assert_array_equal(pd2 >= 0.5 * pknn._INF, inf)
    assert inf.any() and not inf.all()
    np.testing.assert_allclose(pd2[~inf], jd2[~inf], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    qi, qm = pknn.knn_neighbors(T(x), T(mask), 4)
    assert torch.equal(qi, pi) and torch.equal(qm, pm)


@pytest.mark.parametrize("k", [2, NP + 2])
@pytest.mark.parametrize("points", ["random", "tied"])
def test_hybrid_neighbors_match_jax(points, k):
    x, mask = _tied_points() if points == "tied" else (
        _inputs(2)["x"], _inputs(2)["mask"])
    ji, jm = jknn.hybrid_neighbors(jnp.asarray(x), jnp.asarray(mask), NP, k)
    pi, pm = pknn.hybrid_neighbors(T(x), T(mask), NP, k)
    assert tuple(pi.shape) == (B, N, NL + min(k, N - 1))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
