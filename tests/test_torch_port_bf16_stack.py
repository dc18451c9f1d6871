"""The port's fused layer stack under bf16 and on other neighbour tables,
against the JAX package on the same packed weights and inputs (the small
stack of tests/test_torch_port_stack_merged.py):

- bf16 inter-stage blocks (`fused_block_dtype` on 'pallas' and 'pallas2'):
  the port's plain stages against `layer_stack_pallas(..., interpret=True,
  block_dtype=jnp.bfloat16)` within 1e-2 x max(|ref|, 1) on h, x and hb;
  the stored blocks pre_t and q_z within one bf16 unit in the last place of
  the larger value, plus the float32 stages' own tolerance (1e-4 on pre_t,
  whose JAX angle is a polynomial, 1e-6 on q_z);
- 'xla2' with bf16 carries (`run_stack('xla2', block_dtype=bf16)`: the
  plain stages computing in the carries' dtype) against
  `layer_stack_xla2(..., dtype=bf16)` within 2e-2 x max(|ref|, 1), and
  closer to it on average than the float32 stack is (so a cast left in
  float32 shows);
- `run_stack`'s five modes at float32 bit for bit alike;
- the straight-through backward: with bf16 blocks the gradients of
  `LayerStackFn` equal those of the float32 plain stack (1e-5);
- radius and hybrid neighbour tables on the fused stack against
  `layer_stack_xla` (1e-5), and the refusal of act_fn other than relu.
On the CPU the kernel wrappers run their plain versions; the CUDA kernels
are held to those on the card (tests/test_torch_port_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.ops import knn as jknn
from phoregen_tpu.ops import layer_stack as jls

from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.ops import kernel_check as kc
from phoregen_tpu_torch.ops import layer_stack as pls
from phoregen_tpu_torch.ops.kernel_check import bf16_ulp

import torch_port_common as C
from test_torch_port_model import port_config, small_config
from test_torch_port_stack_merged import _make_setup

BF = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def setup():
    return _make_setup()


def _args(s):
    inp = s["inp"]
    return _t(inp["h"]), _t(inp["x"]), _t(inp["hb"])


def _close_scaled(out, ref, tol):
    """|out - ref| <= tol x max(|ref|, 1), elementwise."""
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    bad = np.abs(out - ref) > tol * np.maximum(np.abs(ref), 1.0)
    assert not bad.any(), float(np.abs(out - ref).max())


@pytest.mark.parametrize("fused", ["pallas", "pallas2"])
def test_bf16_block_stack_matches_jax_pallas_interpret(setup, fused):
    s = setup
    merge = fused == "pallas2"
    inp = s["inp"]
    ref = jls.layer_stack_pallas(
        s["jp"], jnp.asarray(inp["h"]), jnp.asarray(inp["x"]),
        jnp.asarray(inp["hb"]), s["jt"], s["jd"], interpret=True,
        merge_node_pre=merge, merge_pos=merge, block_dtype=jnp.bfloat16)
    pls.reset_launch_counts()
    out = pls.layer_stack(s["pp"], *_args(s), s["pt"], s["pd"],
                          merge_node_pre=merge, merge_pos=merge,
                          block_dtype=BF)
    assert not any(pls.LAUNCHES.values())      # CPU tensors: no kernel
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        _close_scaled(o, r, 1e-2)
    # the blocks really were rounded: the float32 stack differs
    f32 = pls.layer_stack(s["pp"], *_args(s), s["pt"], s["pd"],
                          merge_node_pre=merge, merge_pos=merge)
    assert not torch.equal(out[2], f32[2])


@pytest.mark.parametrize("layer", [0, 2])
def test_bf16_blocks_are_the_float32_ones_rounded(setup, layer):
    """The stored pre_t and q_z of the port (plain B1, and the merged A+B1)
    against the JAX stage's float32 result rounded to bf16 as its pallas
    output does (`val.astype(o_ref.dtype)`)."""
    s = setup
    inp, NL = s["inp"], s["pd"].NL
    jw = jax.tree_util.tree_map(lambda a: a[layer], s["jp"])
    pw = pls.layer_weights(s["pp"], layer)
    pre_ref, qz_ref = [], []
    for b in range(s["B"]):
        sl, qz = jls._stage_triplet_pre(
            jw, inp["h"][b], inp["x"][b], inp["hb"][b],
            {k: v[b] for k, v in s["jt"].items()}, s["jd"])
        pre_ref.append(np.stack([np.asarray(a.astype(jnp.bfloat16),
                                            np.float32) for a in sl], 2))
        qz_ref.append(np.asarray(qz.astype(jnp.bfloat16),
                                 np.float32).reshape(NL, NL, C.H))
    pre_t, q_z = pls.stage_triplet_pre(pw, *_args(s), s["pt"], s["pd"], BF)
    _, pre_m, qz_m = pls.stage_node_pre(pw, *_args(s), s["pt"], s["pd"], BF)
    assert pre_t.dtype == q_z.dtype == BF
    assert torch.equal(pre_t, pre_m) and torch.equal(q_z, qz_m)
    valid = s["pt"]["trip_mask"].numpy().astype(bool)      # [B, j, K8]
    sel = np.broadcast_to(valid[:, :, None, :, None], pre_t.shape)
    for got, ref, tol in ((pre_t.float()[torch.from_numpy(sel.copy())],
                           np.stack(pre_ref)[sel], 1e-4),
                          (q_z.float(), np.stack(qz_ref), 1e-6)):
        ref = torch.from_numpy(np.ascontiguousarray(ref))
        ulp = bf16_ulp(torch.maximum(got.abs(), ref.abs()))
        assert bool(((got - ref).abs() <= ulp + tol).all()), \
            float((got - ref).abs().max())


def test_xla2_bf16_matches_jax_xla2_bf16(setup):
    s = setup
    inp = s["inp"]
    jargs = (s["jp"], jnp.asarray(inp["h"]), jnp.asarray(inp["x"]),
             jnp.asarray(inp["hb"]), s["jt"], s["jd"])
    ref = jls.layer_stack_xla2(*jargs, dtype=jnp.bfloat16)
    ref32 = jls.layer_stack_xla2(*jargs)
    # the carries h and hb in bf16, as a bf16 network hands them in (the
    # JAX stack rounds its float32 ones to bf16 at its entry the same way)
    h, x, hb = _args(s)
    out = pls.run_stack("xla2", s["pp"], h.to(BF), x, hb.to(BF), s["pt"],
                        s["pd"], block_dtype=BF)
    assert [o.dtype for o in out] == [BF, torch.float32, BF]
    for o, r, r32 in zip(out, ref, ref32):
        _close_scaled(o, r, 2e-2)
        o, r, r32 = (o.float().numpy(), np.asarray(r, np.float32),
                     np.asarray(r32))
        # the port's bf16 rounding follows the JAX package's, not float32
        assert np.abs(o - r).mean() < 0.75 * np.abs(r32 - r).mean()


def test_xla2_bf16_is_differentiable_and_remats(setup):
    s = setup
    pp = {k: v.clone().requires_grad_(True) for k, v in s["pp"].items()}
    grads = []
    for remat in (False, True):
        out = pls.run_stack("xla2", pp, *_args(s), s["pt"], s["pd"],
                            block_dtype=BF, remat=remat)
        loss = sum(o.float().square().sum() for o in out)
        grads.append(torch.autograd.grad(loss, [pp["lin_W"], pp["e_W"]]))
    for a, b in zip(*grads):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def small_case():
    """A seeded `flagship_case` at small widths, two layers."""
    c = kc.flagship_case(B=2, NP=8, NL=12, H=32, heads=4, Wt=8, K=8,
                         trip_k=4, seed=9, device="cpu")
    c["packed"] = {k: torch.stack([v, 0.5 * v]) for k, v in c["w"].items()}
    return c


@pytest.mark.parametrize("mode", sorted(pls.FUSED_STACKS))
def test_run_stack_modes_agree_at_float32(small_case, mode):
    """Every `fused_stack` value's float32 forward through `run_stack` is
    the plain stages' bit for bit (on the CPU the kernel wrappers run
    them); 'xla2' with bf16 returns h and hb in bf16 and x in float32."""
    c = small_case
    args = (c["packed"], c["h"], c["x"], c["hb"], c["t"], c["d"])
    ref = pls.layer_stack(*args, use_kernels=False)
    out = pls.run_stack(mode, *args)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and torch.equal(o, r)
    if mode == "xla2":
        out = pls.run_stack(mode, c["packed"], c["h"].to(BF), c["x"],
                            c["hb"].to(BF), c["t"], c["d"], block_dtype=BF)
        assert [o.dtype for o in out] == [BF, torch.float32, BF]
        assert not torch.equal(out[1], ref[1])


@pytest.mark.parametrize("fused", ["pallas", "pallas3", "pallas2"])
def test_bf16_block_backward_is_straight_through(setup, fused):
    """`make_layer_stack_grad(block_dtype=bf16)` (plain stages with bf16
    blocks forward on the CPU) pulls fixed cotangents back exactly as
    autograd through the float32 plain stack: to the packed weights, h, x,
    hb, e_w and phore_norm, 1e-5 of each leaf's largest gradient."""
    s = setup
    merges = {"pallas": (False, False), "pallas3": (True, False),
              "pallas2": (True, True)}[fused]
    g = torch.Generator().manual_seed(0)
    grads = []
    for st in (True, False):
        packed = {k: v.clone().requires_grad_(True)
                  for k, v in s["pp"].items()}
        ins = [a.clone().requires_grad_(True) for a in _args(s)]
        t = dict(s["pt"])
        for k in ("e_w", "phore_norm"):
            t[k] = t[k].clone().requires_grad_(True)
        if st:
            out = pls.make_layer_stack_grad(s["pd"], *merges,
                                            block_dtype=BF)(packed, *ins, t)
        else:
            out = pls.layer_stack(packed, *ins, t, s["pd"],
                                  use_kernels=False)
        g.manual_seed(0)
        loss = sum((o * torch.randn(o.shape, generator=g)).sum()
                   for o in out)
        leaves = ins + [t["e_w"], t["phore_norm"]] + [
            packed[k] for k in sorted(packed)]
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for a, b in zip(*grads):
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0
            continue
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) / scale < 1e-5


def _cutoff_tables(inp, cutoff):
    """The JAX and port tables of the small stack for the neighbour table
    of `cutoff` ('radius': the K nearest within 2.5; 'hybrid': every
    ligand slot plus the K nearest phore points, NL + K columns)."""
    x, nm = jnp.asarray(inp["x"]), jnp.asarray(inp["node_mask"])
    if cutoff == "radius":
        ni, nmk = jknn.radius_neighbors(x, nm, C.K, 2.5)
    else:
        ni, nmk = jknn.hybrid_neighbors(x, nm, C.NP, C.K)
    B, N, K = ni.shape
    is_lig = jnp.concatenate([jnp.zeros(C.NP), jnp.ones(C.NL)]).astype(bool)
    src = jnp.take(is_lig, ni)
    dst = jnp.broadcast_to(is_lig[None, :, None], src.shape)
    et = jax.nn.one_hot(3 - 2 * src.astype(jnp.int32)
                        - dst.astype(jnp.int32), 4, dtype=jnp.float32)
    e_w = np.random.default_rng(3).uniform(0.2, 1.0, size=(B, N, K)
                                           ).astype(np.float32)
    jt = jls.build_block_tables(x, nm, ni, nmk, C.NP, C.TRIP_K)
    jt["edge_type"] = et.reshape(B, N * K, 4)
    jt["e_w"] = jnp.asarray(e_w).reshape(B, N * K, 1)
    jt["phore_norm"] = jnp.asarray(inp["phore_norm"])
    pt = pls.build_block_tables(_t(inp["x"]), _t(inp["node_mask"]),
                                _t(np.array(ni)), _t(np.array(nmk)), C.NP,
                                C.TRIP_K)
    pt.update(edge_type=_t(np.array(et)), e_w=_t(e_w),
              phore_norm=_t(inp["phore_norm"]))
    dims = dict(NP=C.NP, NL=C.NL, K=K, K8=min(C.TRIP_K, C.NL - 1), H=C.H,
                heads=C.HEADS, Wt=C.WT)
    return jt, pt, jls.StackDims(**dims), pls.StackDims(**dims)


@pytest.mark.parametrize("fused", ["xla", "pallas2"])
@pytest.mark.parametrize("cutoff", ["radius", "hybrid"])
def test_fused_stack_on_radius_and_hybrid_tables_matches_jax(setup, cutoff,
                                                            fused):
    s = setup
    inp = s["inp"]
    jt, pt, jd, pd = _cutoff_tables(inp, cutoff)
    if cutoff == "hybrid":
        assert pd.K == C.NL + C.K
    ref = jls.layer_stack_xla(s["jp"], jnp.asarray(inp["h"]),
                              jnp.asarray(inp["x"]), jnp.asarray(inp["hb"]),
                              jt, jd)
    merge = fused == "pallas2"
    out = pls.layer_stack(s["pp"], *_args(s), pt, pd,
                          use_kernels=fused != "xla", merge_node_pre=merge,
                          merge_pos=merge)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("cutoff", ["radius", "hybrid"])
def test_fused_config_takes_radius_and_hybrid_and_refuses_gelu(cutoff):
    """cutoff_mode radius / hybrid build on the fused stack (the JAX package
    runs it on those tables); act_fn other than relu is refused, because
    the stages hard-code relu."""
    cfg = port_config(small_config("xla"), "pallas2")
    cfg.model.denoiser.cutoff_mode = cutoff
    assert PhoreGen(cfg).net.denoiser.fused_stack == "pallas2"
    cfg.model.denoiser.act_fn = "gelu"
    with pytest.raises(ValueError, match="act_relu"):
        PhoreGen(cfg)
