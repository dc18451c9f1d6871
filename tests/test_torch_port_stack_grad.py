"""The backward of the port's fused layer stack (`LayerStackFn`: forward
through the stage wrappers, backward by recomputing one layer at a time
through the plain stages) against `jax.vjp` of the JAX package's
`layer_stack_xla`, which is what its `make_layer_stack_grad` pulls back
through. Gradients are taken with respect to the RAW stacked layer
parameters (through each package's `pack_layer_params`, so the packing is
held to be differentiable too), h, x, hb and the differentiable tables e_w
and phore_norm, for one random cotangent made with numpy.

Tolerance: per leaf, max abs error / max(largest |gradient| of the leaf,
1e-3) < 1e-4 (float32 on both sides; the JAX stages take the triplet angle
from a polynomial atan2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.ops import layer_stack as jls
from phoregen_tpu_torch.ops import layer_stack as pls
from phoregen_tpu_torch.utils.checkpoint import flatten_tree

import torch_port_common as C

MERGES = {"pallas": (False, False), "pallas3": (True, False),
          "pallas2": (True, True)}
REL_TOL = 1e-4


def _rel_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()
                 / max(float(np.abs(ref).max()), 1e-3))


@pytest.fixture(scope="module")
def setup():
    tree = C.layer_tree(0)
    # two of the three layers keep the JAX compile small
    tree = jax.tree_util.tree_map(lambda a: a[:2], tree)
    inp = C.stack_inputs(1)
    jt, nbr_idx, nbr_mask, etype = C.jax_tables(inp)
    pt = C.port_tables(inp, nbr_idx, nbr_mask, etype)
    jd = jls.StackDims(NP=C.NP, NL=C.NL, K=C.K, K8=min(C.TRIP_K, C.NL - 1),
                       H=C.H, heads=C.HEADS, Wt=C.WT)
    rng = np.random.default_rng(11)
    cot = [rng.normal(size=inp[k].shape).astype(np.float32)
           for k in ("h", "x", "hb")]

    def f(tr, h, x, hb, e_w, pn):
        t = dict(jt, e_w=e_w.reshape(C.B, -1, 1), phore_norm=pn)
        return jls.layer_stack_xla(jls.pack_layer_params(tr, C.H, C.FE),
                                   h, x, hb, t, jd)

    args = (jax.tree_util.tree_map(jnp.asarray, tree),
            *(jnp.asarray(inp[k]) for k in ("h", "x", "hb", "e_w",
                                            "phore_norm")))
    _, vjp = jax.vjp(f, *args)
    ref = vjp(tuple(jnp.asarray(c) for c in cot))
    return dict(tree=tree, inp=inp, pt=pt, cot=cot, ref=ref)


def _port_grads(s, run):
    """Gradients of sum(out * cot) for `run(packed, h, x, hb, tables)`."""
    leaf = lambda a: torch.from_numpy(np.asarray(a)).clone().requires_grad_()
    tree = jax.tree_util.tree_map(leaf, s["tree"])
    ins = [leaf(s["inp"][k]) for k in ("h", "x", "hb")]
    t = dict(s["pt"], e_w=leaf(s["inp"]["e_w"]),
             phore_norm=leaf(s["inp"]["phore_norm"]))
    out = run(pls.pack_layer_params(tree, C.H, C.FE), *ins, t)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(out, s["cot"]))
    flat = flatten_tree(tree)
    grads = torch.autograd.grad(
        loss, list(flat.values()) + ins + [t["e_w"], t["phore_norm"]])
    n = len(flat)
    return dict(zip(flat, grads[:n])), grads[n:]


@pytest.mark.parametrize("fused", sorted(MERGES))
def test_layer_stack_fn_gradients_match_jax_vjp(setup, fused):
    s = setup
    g_tree, g_rest = _port_grads(
        s, pls.make_layer_stack_grad(C.dims(), *MERGES[fused]))
    ref_tree = flatten_tree(jax.tree_util.tree_map(np.asarray, s["ref"][0]))
    assert set(g_tree) == set(ref_tree)
    bad = {k: _rel_err(g_tree[k], ref_tree[k]) for k in ref_tree
           if _rel_err(g_tree[k], ref_tree[k]) >= REL_TOL}
    assert not bad, bad
    for name, g, r in zip(("h", "x", "hb", "e_w", "phore_norm"), g_rest,
                          s["ref"][1:]):
        assert torch.isfinite(g).all(), name
        assert _rel_err(g, r) < REL_TOL, (name, _rel_err(g, r))


def test_layer_by_layer_recompute_equals_whole_stack_autograd(setup):
    """`LayerStackFn`'s backward against autograd through the whole plain
    stack (with and without per-layer checkpointing): 1e-6 of each leaf's
    largest gradient."""
    s = setup
    fn = _port_grads(s, pls.make_layer_stack_grad(C.dims(), True, True))
    for remat in (False, True):
        whole = _port_grads(s, lambda p, h, x, hb, t: pls.layer_stack(
            p, h, x, hb, t, C.dims(), use_kernels=False, remat=remat))
        for k in whole[0]:
            assert _rel_err(fn[0][k], whole[0][k]) < 1e-6, k
        for a, b in zip(fn[1], whole[1]):
            assert _rel_err(a, b) < 1e-6


def test_index_and_mask_tables_get_no_gradient(setup):
    s = setup
    leaf = lambda a: torch.from_numpy(np.asarray(a)).clone().requires_grad_()
    t = dict(s["pt"])
    t["nbr_mask"] = t["nbr_mask"].clone().requires_grad_()
    packed = pls.pack_layer_params(C.tree_to_torch(s["tree"]), C.H, C.FE)
    h = leaf(s["inp"]["h"])
    out = pls.make_layer_stack_grad(C.dims(), True, True)(
        packed, h, torch.from_numpy(s["inp"]["x"]),
        torch.from_numpy(s["inp"]["hb"]), t)
    g_h, g_mask = torch.autograd.grad(out[0].sum(), [h, t["nbr_mask"]],
                                      allow_unused=True)
    assert g_mask is None and torch.isfinite(g_h).all()


def test_no_grad_mode_skips_the_function(setup):
    """Sampling runs under no_grad: the trainable wrapper is then the plain
    `layer_stack` call and saves nothing."""
    s = setup
    packed = pls.pack_layer_params(C.tree_to_torch(s["tree"]), C.H, C.FE)
    args = (packed, *(torch.from_numpy(s["inp"][k])
                      for k in ("h", "x", "hb")), s["pt"])
    with torch.no_grad():
        out = pls.make_layer_stack_grad(C.dims(), True, True)(*args)
    ref = pls.layer_stack(*args, C.dims(), merge_node_pre=True,
                          merge_pos=True)
    for a, b in zip(out, ref):
        assert not a.requires_grad and torch.equal(a, b)


@pytest.mark.parametrize("fused", ["pallas2", "xla2", "none"])
def test_grad_finite_padded(fused):
    """The padded batch of tests/test_layer_stack.py::
    test_xla2_grad_finite_padded (graphs smaller than the bucket, so fully
    masked softmax rows): loss and every parameter gradient finite."""
    from phoregen_tpu.data.loader import PhoreDataLoader
    from phoregen_tpu.data.synthetic import synthetic_dataset
    from phoregen_tpu_torch.data.batching import PhoreGraphBatch
    from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params
    from test_torch_port_model import port_config, small_config
    jcfg = small_config("xla")
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    assert not bool(tb.lig_mask.all())
    pg = PhoreGen(port_config(jcfg, fused))
    init_params(pg.net, 0)
    loss, _ = pg.compute_loss(tb, torch.Generator().manual_seed(11))
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    bad = [n for n, p in pg.net.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all()]
    assert not bad, bad
