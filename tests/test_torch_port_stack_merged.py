"""The merged stages of the port's fused layer stack (`fused_stack`
'pallas3' and 'pallas2') against the JAX package, on the same packed
weights and the same inputs. On the CPU the port's wrappers run their plain
PyTorch versions; the CUDA kernels are held against those on the card
(`chip_smoke.py`, tests/test_torch_port_cuda.py). The JAX Pallas kernels run
in interpret mode, as the JAX package's own tests run them on the CPU.

Tolerances: single stages 1e-5 where no triplet angle enters (the JAX
stages compute it with a polynomial atan2 accurate to ~1e-5 rad, the port
with atan2: `pre_t` gets 1e-4), stacks and whole forwards 1e-4.

The merged stages also run at a second, ragged size (`RAGGED`): the plain
versions are what the card holds the kernels to, so they must be right
where a kernel's tiles end unevenly: NL no multiple of 8, fewer triplet
sources than NL - 1, an odd kNN width, and a graph whose ligand rows are all
padding."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.ops import layer_stack as jls
from phoregen_tpu_torch.ops import layer_stack as pls

import torch_port_common as C
from test_torch_port_model import (_inputs, models, port_config,  # noqa: F401
                                   small_config)

TOL5 = dict(atol=1e-5, rtol=1e-5)
TOL4 = dict(atol=1e-4, rtol=1e-4)
MERGES = {"pallas": (False, False), "pallas3": (True, False),
          "pallas2": (True, True)}


RAGGED = dict(NP=5, NL=11, K=5, TRIP_K=4, B=3)


def _make_setup(empty_graph=None):
    tree = C.layer_tree(0)
    inp = C.stack_inputs(1)
    if empty_graph is not None:
        inp["node_mask"][empty_graph, C.NP:] = False
    jt, nbr_idx, nbr_mask, etype = C.jax_tables(inp)
    pt = C.port_tables(inp, nbr_idx, nbr_mask, etype)
    jpacked = jls.pack_layer_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                    C.H, C.FE)
    ppacked = pls.pack_layer_params(C.tree_to_torch(tree), C.H, C.FE)
    jdims = jls.StackDims(NP=C.NP, NL=C.NL, K=C.K,
                          K8=min(C.TRIP_K, C.NL - 1), H=C.H, heads=C.HEADS,
                          Wt=C.WT)
    return dict(inp=inp, jt=jt, pt=pt, jp=jpacked, pp=ppacked,
                jd=jdims, pd=C.dims(), B=C.B)


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


@pytest.fixture(scope="module")
def ragged_setup():
    """The same stack at the sizes of `RAGGED`, graph 2 without a valid
    ligand atom (the shared helpers read their sizes when called)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in RAGGED.items():
            mp.setattr(C, k, v)
        return _make_setup(empty_graph=2)


def _case(request, layer):
    """(setup, layer) of a `layer` parameter: an int is that layer of the
    small stack, 'ragged' layer 1 of the ragged one."""
    if layer == "ragged":
        return request.getfixturevalue("ragged_setup"), 1
    return request.getfixturevalue("setup"), layer


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("layer", [0, 2, "ragged"])
def test_stage_node_pre_matches_jax(request, layer):
    s, layer = _case(request, layer)
    inp, NL = s["inp"], s["pd"].NL
    jw = jax.tree_util.tree_map(lambda a: a[layer], s["jp"])
    pw = pls.layer_weights(s["pp"], layer)
    nh_ref, pre_ref, qz_ref = [], [], []
    for b in range(s["B"]):
        nh, sl, qz = jls._stage_node_pre(
            jw, inp["h"][b], inp["x"][b], inp["hb"][b],
            {k: v[b] for k, v in s["jt"].items()}, s["jd"])
        nh_ref.append(np.asarray(nh))
        # JAX slices are [K8][j, i, Wt]; the port lays pre_t out [j, i, K8, Wt]
        pre_ref.append(np.stack([np.asarray(a) for a in sl], 2))
        qz_ref.append(np.asarray(qz).reshape(NL, NL, C.H))
    new_h, pre_t, q_z = pls.stage_node_pre(
        pw, _t(inp["h"]), _t(inp["x"]), _t(inp["hb"]), s["pt"], s["pd"])
    np.testing.assert_allclose(new_h.numpy(), np.stack(nh_ref), **TOL5)
    np.testing.assert_allclose(q_z.numpy(), np.stack(qz_ref), **TOL5)
    # slots of masked triplet sources hold an arbitrary source and are
    # inert downstream: compare the valid sources
    valid = s["pt"]["trip_mask"].numpy().astype(bool)      # [B, j, K8]
    sel = np.broadcast_to(valid[:, :, None, :, None], pre_t.shape)
    np.testing.assert_allclose(pre_t.numpy()[sel], np.stack(pre_ref)[sel],
                               **TOL4)
    # the merged version is the two single stages, bit for bit
    a = pls.stage_node(pw, _t(inp["h"]), _t(inp["x"]), _t(inp["hb"]),
                       s["pt"], s["pd"])
    b1 = pls.stage_triplet_pre(pw, _t(inp["h"]), _t(inp["x"]),
                               _t(inp["hb"]), s["pt"], s["pd"])
    assert torch.equal(a, new_h) and torch.equal(b1[0], pre_t)
    assert torch.equal(b1[1], q_z)


@pytest.mark.parametrize("layer", [0, 1, "ragged"])
def test_stage_att_pos_matches_jax_pallas_kernel(request, layer):
    """Against `_att_pos_pallas` itself (interpret mode): the head grid
    accumulating hb_new, the pos update in the last head's step."""
    s, layer = _case(request, layer)
    inp, B, NL, NP = s["inp"], s["B"], s["pd"].NL, s["pd"].NP
    jw = jax.tree_util.tree_map(lambda a: a[layer], s["jp"])
    pw = pls.layer_weights(s["pp"], layer)
    rng = np.random.default_rng(3 + layer)
    K8 = s["pd"].K8
    pre = rng.normal(size=(B, NL, NL, K8, C.WT)).astype(np.float32)
    qz = rng.normal(size=(B, NL, NL, C.H)).astype(np.float32)
    new_h = rng.normal(size=inp["h"].shape).astype(np.float32)
    hb_ref, x_ref = jls._att_pos_pallas(s["jd"], True)(
        jw, s["jt"], jnp.asarray(inp["hb"]),
        jnp.asarray(np.transpose(pre, (0, 3, 1, 2, 4))),    # [B,K8,j,i,Wt]
        jnp.asarray(qz.reshape(B, NL * NL, C.H)), jnp.asarray(new_h),
        jnp.asarray(inp["x"]))
    hb_new, x_new = pls.stage_att_pos(
        pw, _t(inp["hb"]), _t(pre), _t(qz), _t(new_h), _t(inp["x"]),
        s["pt"], s["pd"])
    np.testing.assert_allclose(hb_new.numpy(), np.asarray(hb_ref), **TOL5)
    np.testing.assert_allclose(x_new.numpy(), np.asarray(x_ref), **TOL5)
    # phore rows and padded ligand rows never move
    np.testing.assert_array_equal(x_new.numpy()[:, :NP], inp["x"][:, :NP])
    np.testing.assert_array_equal(x_new.numpy()[1, -2:], inp["x"][1, -2:])
    if B > 2:       # the graph without a ligand atom: only the output bias
        np.testing.assert_array_equal(x_new.numpy()[2], inp["x"][2])
        torch.testing.assert_close(hb_new[2],
                                   _t(inp["hb"])[2] + pw["t_out_b"])


@pytest.mark.parametrize("fused", sorted(MERGES))
def test_layer_stack_merges_match_layer_stack_xla(setup, fused):
    s, inp = setup, setup["inp"]
    ref = jls.layer_stack_xla(s["jp"], jnp.asarray(inp["h"]),
                              jnp.asarray(inp["x"]), jnp.asarray(inp["hb"]),
                              s["jt"], s["jd"])
    merge_node_pre, merge_pos = MERGES[fused]
    pls.reset_launch_counts()
    out = pls.layer_stack(s["pp"], _t(inp["h"]), _t(inp["x"]),
                          _t(inp["hb"]), s["pt"], s["pd"],
                          merge_node_pre=merge_node_pre, merge_pos=merge_pos)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL4)
    assert not any(pls.LAUNCHES.values())    # CPU tensors: no kernel


def test_fully_masked_rows_take_the_floor(setup):
    """A graph with no valid ligand atom: every softmax row is fully
    masked, the denominators floor at 1, so the bond grid gets only the
    output bias and x does not move; all finite."""
    s, inp = setup, setup["inp"]
    pw = pls.layer_weights(s["pp"], 0)
    t = dict(s["pt"])
    for k in ("mask_l", "trip_mask", "lig3_mask"):
        t[k] = t[k].clone()
        t[k][1] = 0.0
    rng = np.random.default_rng(9)
    K8 = s["pd"].K8
    pre = _t(rng.normal(size=(C.B, C.NL, C.NL, K8, C.WT)).astype(np.float32))
    qz = _t(rng.normal(size=(C.B, C.NL, C.NL, C.H)).astype(np.float32))
    hb_new, x_new = pls.stage_att_pos(pw, _t(inp["hb"]), pre, qz,
                                      _t(inp["h"]), _t(inp["x"]), t, s["pd"])
    assert torch.isfinite(hb_new).all() and torch.isfinite(x_new).all()
    torch.testing.assert_close(hb_new[1], _t(inp["hb"])[1] + pw["t_out_b"])
    assert torch.equal(x_new[1], _t(inp["x"])[1])


@pytest.mark.parametrize("fused", ["pallas3", "pallas2"])
def test_forward_with_merged_stacks_matches_jax_xla(models, fused):
    """Whole network, `fused_stack` 'pallas3' / 'pallas2' in the port (these
    values used to raise) against the JAX package's 'xla' forward."""
    from phoregen_tpu_torch.data.batching import PhoreGraphBatch
    from phoregen_tpu_torch.models.phoregen import PhoreGen
    from phoregen_tpu_torch.utils.checkpoint import from_jax_params
    jpg, params, _, batch = models
    pg = PhoreGen(port_config(small_config("xla"), fused))
    assert pg.net.denoiser.fused_stack == fused
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    x = _inputs(batch)
    ref = jpg.net.apply(params, jnp.asarray(x["h_node"]),
                        jnp.asarray(x["pos"]), batch.lig_mask,
                        jnp.asarray(x["h_edge"]), jnp.asarray(x["t"]),
                        batch.phore_x, batch.phore_pos, batch.phore_norm,
                        batch.phore_mask)
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    with torch.no_grad():
        out = pg.net(_t(x["h_node"]), _t(x["pos"]), tb.lig_mask,
                     _t(x["h_edge"]), _t(x["t"]), tb.phore_x, tb.phore_pos,
                     tb.phore_norm, tb.phore_mask)
    lm = np.asarray(batch.lig_mask)
    bm = lm[:, :, None] & lm[:, None, :]
    for o, r, m in zip(out[:3], ref[:3], (lm, lm, bm)):
        np.testing.assert_allclose(o.numpy()[m], np.asarray(r)[m], **TOL4)
