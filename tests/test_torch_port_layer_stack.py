"""The port's fused layer stack (phoregen_tpu_torch/ops/layer_stack.py)
against the JAX package's stage math, on the same packed weights and the
same inputs. On the CPU each stage wrapper runs its plain PyTorch version;
the CUDA kernels are held against those on the card (`chip_smoke.py` and
tests/test_torch_port_cuda.py).

Tolerance atol = rtol = 1e-4: the JAX per-graph stages compute the triplet
angle with a polynomial atan2 accurate to ~1e-5 rad, the port with atan2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.ops import layer_stack as jls
from phoregen_tpu_torch.ops import layer_stack as pls

import torch_port_common as C

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def setup():
    tree = C.layer_tree(0)
    inp = C.stack_inputs(1)
    jt, nbr_idx, nbr_mask, etype = C.jax_tables(inp)
    pt = C.port_tables(inp, nbr_idx, nbr_mask, etype)
    jpacked = jls.pack_layer_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                    C.H, C.FE)
    ppacked = pls.pack_layer_params(C.tree_to_torch(tree), C.H, C.FE)
    jdims = jls.StackDims(NP=C.NP, NL=C.NL, K=C.K,
                          K8=min(C.TRIP_K, C.NL - 1), H=C.H, heads=C.HEADS,
                          Wt=C.WT)
    return dict(inp=inp, jt=jt, pt=pt, jp=jpacked, pp=ppacked,
                jd=jdims, pd=C.dims())


def _per_graph(jt, b):
    return {k: v[b] for k, v in jt.items()}


def _layer(s, l):
    jw = jax.tree_util.tree_map(lambda a: a[l], s["jp"])
    pw = pls.layer_weights(s["pp"], l)
    return jw, pw


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("layer", [0, 2])
def test_stage_node_matches_jax(setup, layer):
    s = setup
    jw, pw = _layer(s, layer)
    inp = s["inp"]
    ref = np.stack([np.asarray(jls._stage_node(
        jw, inp["h"][b], inp["x"][b], inp["hb"][b], _per_graph(s["jt"], b),
        s["jd"])) for b in range(C.B)])
    out = pls.stage_node(pw, _t(inp["h"]), _t(inp["x"]), _t(inp["hb"]),
                         s["pt"], s["pd"])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_stage_triplet_pre_matches_jax(setup):
    s = setup
    jw, pw = _layer(s, 1)
    inp = s["inp"]
    pre_ref, qz_ref = [], []
    for b in range(C.B):
        sl, qz = jls._stage_triplet_pre(jw, inp["h"][b], inp["x"][b],
                                        inp["hb"][b], _per_graph(s["jt"], b),
                                        s["jd"])
        # JAX slices are [K8][j, i, Wt]; the port lays pre_t out [j, i, K8, Wt]
        pre_ref.append(np.stack([np.asarray(a) for a in sl], 2))
        qz_ref.append(np.asarray(qz).reshape(C.NL, C.NL, C.H))
    pre_t, q_z = pls.stage_triplet_pre(pw, _t(inp["h"]), _t(inp["x"]),
                                       _t(inp["hb"]), s["pt"], s["pd"])
    np.testing.assert_allclose(q_z.numpy(), np.stack(qz_ref), **TOL)
    # slots of masked triplet sources hold an arbitrary source (top-k tie
    # order among masked candidates differs between lax.top_k and
    # torch.topk) and are inert downstream: compare the valid sources
    valid = s["pt"]["trip_mask"].numpy().astype(bool)      # [B, j, K8]
    sel = np.broadcast_to(valid[:, :, None, :, None], pre_t.shape)
    np.testing.assert_allclose(pre_t.numpy()[sel], np.stack(pre_ref)[sel],
                               **TOL)


def test_stage_triplet_att_matches_jax(setup):
    s = setup
    jw, pw = _layer(s, 1)
    inp = s["inp"]
    rng = np.random.default_rng(3)
    K8 = s["pd"].K8
    pre = rng.normal(size=(C.B, C.NL, C.NL, K8, C.WT)).astype(np.float32)
    qz = rng.normal(size=(C.B, C.NL, C.NL, C.H)).astype(np.float32)
    ref = []
    for b in range(C.B):
        pre_k = np.transpose(pre[b], (2, 0, 1, 3))          # [K8, j, i, Wt]
        ref.append(np.asarray(jls._stage_triplet_att(
            jw, inp["hb"][b], lambda k, p=pre_k: jnp.asarray(p[k]),
            jnp.asarray(qz[b].reshape(C.NL * C.NL, C.H)),
            _per_graph(s["jt"], b), s["jd"])))
    out = pls.stage_triplet_att(pw, _t(inp["hb"]), _t(pre), _t(qz),
                                s["pt"], s["pd"])
    np.testing.assert_allclose(out.numpy(), np.stack(ref), **TOL)


def test_trip_valid_matches_jax_table(setup):
    s = setup
    ref = np.transpose(np.asarray(s["jt"]["trip_valid"]), (0, 2, 3, 1))
    np.testing.assert_array_equal(pls.trip_valid(s["pt"]).numpy(), ref)


def test_stage_pos_matches_jax(setup):
    s = setup
    jw, pw = _layer(s, 2)
    inp = s["inp"]
    rng = np.random.default_rng(4)
    new_h = rng.normal(size=inp["h"].shape).astype(np.float32)
    hb_new = rng.normal(size=inp["hb"].shape).astype(np.float32)
    ref = np.stack([np.asarray(jls._stage_pos(
        jw, new_h[b], inp["x"][b], hb_new[b], _per_graph(s["jt"], b),
        s["jd"])) for b in range(C.B)])
    out = pls.stage_pos(pw, _t(new_h), _t(inp["x"]), _t(hb_new), s["pt"],
                        s["pd"])
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    # phore rows and padded ligand rows never move
    np.testing.assert_array_equal(out.numpy()[:, :C.NP], inp["x"][:, :C.NP])
    np.testing.assert_array_equal(out.numpy()[1, -2:], inp["x"][1, -2:])


def test_layer_stack_matches_layer_stack_xla(setup):
    s = setup
    inp = s["inp"]
    h, x, hb = jls.layer_stack_xla(s["jp"], jnp.asarray(inp["h"]),
                                   jnp.asarray(inp["x"]),
                                   jnp.asarray(inp["hb"]), s["jt"], s["jd"])
    ph, px, phb = pls.layer_stack(s["pp"], _t(inp["h"]), _t(inp["x"]),
                                  _t(inp["hb"]), s["pt"], s["pd"])
    np.testing.assert_allclose(ph.numpy(), np.asarray(h), **TOL)
    np.testing.assert_allclose(px.numpy(), np.asarray(x), **TOL)
    np.testing.assert_allclose(phb.numpy(), np.asarray(hb), **TOL)


def test_cpu_wrappers_do_not_count_launches(setup):
    s = setup
    pls.reset_launch_counts()
    inp = s["inp"]
    pls.layer_stack(s["pp"], _t(inp["h"]), _t(inp["x"]), _t(inp["hb"]),
                    s["pt"], s["pd"])
    assert all(v == 0 for v in pls.LAUNCHES.values())


def test_trip_k_clamped_to_bucket(setup):
    """triplet_knn >= NL clamps to NL-1 like the kNN itself."""
    s = setup
    inp = s["inp"]
    t = pls.build_block_tables(_t(inp["x"]), _t(inp["node_mask"]),
                               s["pt"]["nbr_idx"], s["pt"]["nbr_mask"],
                               C.NP, 32)
    assert t["trip_idx"].shape == (C.B, C.NL, C.NL - 1)
    assert t["lig3_idx"].shape == (C.B, C.NL, 3)
