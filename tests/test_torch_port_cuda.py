"""The port's CUDA kernels (the four layer-stack stages, the two merged
stages, the forms of four of them with bf16 inter-stage blocks, and the
all-k triplet pool) against their plain PyTorch versions, on the card. Imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Skips where no CUDA device is present (the kernels have no CPU mode)."""
import pytest
import torch

from phoregen_tpu_torch.ops import kernel_check as kc
from phoregen_tpu_torch.ops import layer_stack as ls
from phoregen_tpu_torch.ops import pallas_triplet as pt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


SHAPES = {
    "small": dict(B=2, NP=6, NL=8, H=16, heads=2, Wt=8, K=4, trip_k=3),
    "flagship_nl32": dict(B=4, NP=96, NL=32, trip_k=32),
    # no width a multiple of the kernels' tiles: NL against the row groups,
    # K and K8 against a warp, H and Wt narrower than a 128-column pass
    "ragged": dict(B=3, NP=10, NL=37, H=32, heads=4, Wt=16, K=7, trip_k=5),
    "flagship_nl48": dict(B=2, NP=96, NL=48, trip_k=32),
    "flagship_nl80": dict(B=2, NP=96, NL=80, trip_k=32),
    # graph 0 has no valid ligand atom
    "empty_graph": dict(B=3, NP=10, NL=21, H=32, heads=4, Wt=16, K=7,
                        trip_k=5, empty_first=True),
    # more sources than one pass of the bond-grid attention takes
    "tall": dict(B=1, NP=3, NL=83, H=16, heads=4, Wt=8, K=5, trip_k=6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_plain(cuda, shape):
    case = kc.flagship_case(device=cuda, seed=1, **SHAPES[shape])
    rows = kc.check_kernels(case, reps=1)
    bad = [(r["name"], r["max_abs_err"]) for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["small", "ragged", "flagship_nl48",
                                   "flagship_nl80", "empty_graph", "tall"])
def test_bf16_block_kernels_match_plain(cuda, shape):
    """The forms of rows 2, 3, 5 and 6 with bf16 blocks pre_t and q_z:
    stored blocks within the float32 tolerance plus one bf16 unit in the
    last place, everything downstream at the float32 rows' tolerances."""
    case = kc.flagship_case(device=cuda, seed=1, **SHAPES[shape])
    rows = kc.check_kernels(case, reps=1, kernels=kc.BF16_KERNELS)
    bad = [(r["name"], r["max_abs_err"]) for r in rows if not r["ok"]]
    assert not bad, bad


HYBRID_SHAPES = {
    # NL + K sources a ligand row: 112 at the flagship's NL = 80, two
    # passes over the edge tiles
    "flagship_nl80": dict(B=2, NP=96, NL=80, trip_k=32),
    "flagship_nl48": dict(B=2, NP=96, NL=48, trip_k=32),
    "small": dict(B=2, NP=6, NL=8, H=16, heads=2, Wt=8, K=4, trip_k=3),
    "ragged": dict(B=3, NP=10, NL=37, H=64, heads=4, Wt=16, K=7, trip_k=5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(HYBRID_SHAPES))
def test_kernels_match_plain_on_hybrid_tables(cuda, shape):
    """Rows 1, 4, 5 and 6 on the hybrid cutoff's neighbour table."""
    case = kc.flagship_case(device=cuda, seed=4, cutoff="hybrid",
                            **HYBRID_SHAPES[shape])
    rows = kc.check_kernels(case, reps=1, kernels=kc.KNN_KERNELS)
    bad = [(r["name"], r["max_abs_err"]) for r in rows if not r["ok"]]
    assert not bad, bad


MERGES = {
    "pallas": (False, False, ("stage_node", "stage_triplet_pre",
                              "stage_triplet_att", "stage_pos")),
    "pallas3": (True, False, ("stage_node_pre", "stage_triplet_att",
                              "stage_pos")),
    "pallas2": (True, True, ("stage_node_pre", "stage_att_pos")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(MERGES))
def test_wrappers_count_launches(cuda, setting):
    """Each setting launches its own kernels once a layer and no other,
    and agrees with the plain stack (1e-4; two layers)."""
    merge_node_pre, merge_pos, names = MERGES[setting]
    case = kc.flagship_case(device=cuda, seed=2,
                            **SHAPES["small"])
    ls.reset_launch_counts()
    packed = {k: torch.stack([v, v]) for k, v in case["w"].items()}
    args = (packed, case["h"], case["x"], case["hb"], case["t"], case["d"])
    got = ls.layer_stack(*args, merge_node_pre=merge_node_pre,
                         merge_pos=merge_pos)
    assert ls.LAUNCHES == {k: 2 * (k in names) for k in ls.LAUNCHES}
    ref = ls.layer_stack(*args, use_kernels=False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship_nl48", "ragged", "empty_graph"])
def test_node_kernel_skips_padded_destinations(cuda, shape):
    """NaN bond features towards every padded ligand slot leave stage A's
    kernel output finite and change none of its bits: it runs no bond grid
    there (one that did would pool 0 * NaN = NaN). It and the merged A +
    B1's new_h stay within 1e-4 of the plain version on the unfilled
    features, padded rows included."""
    case = kc.flagship_case(device=cuda, seed=3, **SHAPES[shape])
    w, t, d, h, x = case["w"], case["t"], case["d"], case["h"], case["x"]
    ml = t["mask_l"]
    assert (ml == 0).any()
    hb = case["hb"].clone()
    pad = (ml == 0)[:, None, :, None].expand_as(hb)
    hb[pad] = float("nan")
    before = ls.stage_node(w, h, x, case["hb"], t, d)
    after = ls.stage_node(w, h, x, hb, t, d)
    merged = ls.stage_node_pre(w, h, x, hb, t, d)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(after).all() and torch.isfinite(merged).all()
    assert torch.equal(after, before)
    ref = ls.stage_node_plain(w, h, x, case["hb"], t, d)
    torch.testing.assert_close(after, ref, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(merged, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship_nl48", "ragged", "empty_graph"])
def test_node_kernel_reads_no_fold_of_padded_rows(cuda, shape, monkeypatch):
    """Stage A's scratch (`_node_scratch`: the node projections, then the
    kNN-edge folds of every node and the bond-grid folds of every ligand
    row) filled with NaN before each launch: the outputs of stage_node and
    of the merged A + B1 stay finite and bit-equal to runs on unfilled
    scratch, and the bond-grid folds of the padded ligand rows are still
    NaN afterwards (the query phase forms none, node_kernel reads none)."""
    case = kc.flagship_case(device=cuda, seed=3, **SHAPES[shape])
    w, t, d, h, x, hb = (case[k] for k in ("w", "t", "d", "h", "x", "hb"))
    ml = t["mask_l"]
    assert (ml == 0).any()
    before = ls.stage_node(w, h, x, hb, t, d)
    before_pre = ls.stage_node_pre(w, h, x, hb, t, d)
    made, scratch = [], ls._node_scratch

    def nan_scratch(d_, B, PW, device):
        P = scratch(d_, B, PW, device).fill_(float("nan"))
        made.append((P, PW))
        return P

    monkeypatch.setattr(ls, "_node_scratch", nan_scratch)
    after = ls.stage_node(w, h, x, hb, t, d)
    after_pre = ls.stage_node_pre(w, h, x, hb, t, d)
    torch.cuda.synchronize()
    assert len(made) == 2
    assert torch.isfinite(after).all() and torch.isfinite(after_pre[0]).all()
    assert torch.equal(after, before)
    for a, b in zip(after_pre, before_pre):
        assert torch.equal(a, b)
    B, fs = h.shape[0], (d.H + 1) * d.heads
    for P, PW in made:
        Fb = P[B * d.N * (PW + fs):].view(B, d.NL, fs)
        assert torch.isnan(Fb[ml == 0]).all()
        assert not torch.isnan(Fb[ml != 0]).any()


def _plan(d, B=2):
    """`ls_launch_plan` of the library for dims `d`: {kernel: (rows a pass,
    bytes a block, destinations a block, blocks an SM)}."""
    from phoregen_tpu_torch.ops import _build
    from phoregen_tpu_torch.tools.compare_kernels import launch_plan
    return launch_plan(_build.load(), (B, d.NP, d.NL, d.K, d.K8, d.H,
                                       d.heads, d.Wt))


def _lig_holes(B, NL, every=3):
    """A ligand mask with every `every`-th slot padded (slot 0 included), so
    that pairs of destinations hold a padded and a filled one each way."""
    m = torch.ones(B, NL, dtype=torch.bool)
    m[:, ::every] = False
    return m


POS_SHAPES = {
    # an odd NL: the last block of two destinations holds one
    "odd_nl": dict(B=2, NP=10, NL=21, H=32, heads=4, Wt=16, K=7, trip_k=5),
    # heads not a multiple of 4, dh = 6 (the fold's scalar dot)
    "heads6": dict(B=2, NP=8, NL=13, H=36, heads=6, Wt=8, K=5, trip_k=4),
    # heads not a multiple of 4, dh = 8
    "heads2": dict(B=3, NP=6, NL=9, H=16, heads=2, Wt=8, K=4, trip_k=3),
    "flagship_nl80": dict(B=2, NP=96, NL=80, trip_k=32),
    "flagship_nl48": dict(B=2, NP=96, NL=48, trip_k=32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "holes"])
@pytest.mark.parametrize("shape", sorted(POS_SHAPES))
def test_pos_kernel_two_destinations(cuda, shape, holes):
    """Stage C takes two destinations a block where `ls_launch_plan` says
    they fit, with the query folded into its key layers: it and B2 + C (one
    destination a block) agree with the plain versions within 1e-4 on odd
    NL (a last block of one destination), on heads that are no multiple of
    4, and with a padded destination beside a filled one (every third
    ligand slot padded: pairs padded | filled and filled | padded)."""
    cfg = dict(POS_SHAPES[shape])
    if holes:
        cfg["lig_mask"] = _lig_holes(cfg["B"], cfg["NL"])
    case = kc.flagship_case(device=cuda, seed=7, **cfg)
    plan = _plan(case["d"], case["B"])
    assert plan["pos_kernel"][2] == 2 and plan["att_pos_kernel"][2] == 1
    rows = kc.check_kernels(case, reps=1, kernels=[
        k for k in kc.KERNELS if k[0] in ("stage_pos", "stage_att_pos")])
    bad = [(r["name"], r["max_abs_err"]) for r in rows if not r["ok"]]
    assert not bad, bad
    # a padded destination keeps its position exactly
    w, t, d = case["w"], case["t"], case["d"]
    calls = kc.stage_calls(case)
    out = calls["stage_pos"][0]()
    pad = t["mask_l"] == 0
    assert torch.equal(out[:, d.NP:][pad], case["x"][:, d.NP:][pad])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["flagship_nl80", "ragged", "small"])
def test_pos_kernel_on_hybrid_tables(cuda, shape):
    """Stage C (two destinations a block where they fit) and B2 + C on the
    hybrid cutoff's table (NL + K sources a ligand row, the edge tiles in
    several passes), with and without padded slots between filled ones."""
    for holes in (False, True):
        cfg = dict(HYBRID_SHAPES[shape])
        if holes:
            cfg["lig_mask"] = _lig_holes(cfg["B"], cfg["NL"], every=4)
        case = kc.flagship_case(device=cuda, seed=8, cutoff="hybrid", **cfg)
        rows = kc.check_kernels(case, reps=1, kernels=[
            k for k in kc.KERNELS if k[0] in ("stage_pos", "stage_att_pos")])
        bad = [(r["name"], r["max_abs_err"]) for r in rows if not r["ok"]]
        assert not bad, (holes, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("nl", [80, 48])
def test_launch_plan_reports_groups_and_residency(cuda, nl):
    """`ls_launch_plan` at the flagship widths: stages A and C two
    destinations a block, B2 + C one; stage B1 two blocks an SM, the
    others one (512 threads at 128 registers fill an SM's registers)."""
    d = ls.StackDims(NP=96, NL=nl, K=32, K8=32, H=128, heads=16, Wt=32)
    plan = _plan(d, 16)
    assert {k: v[2] for k, v in plan.items()} == {
        "node_kernel": 2, "trip_pre_kernel": 1, "trip_att_kernel": 1,
        "pos_kernel": 2, "att_pos_kernel": 1}
    assert plan["trip_pre_kernel"][3] >= 2
    assert all(v[3] == 1 for k, v in plan.items() if k != "trip_pre_kernel")
    assert all(v[0] > 0 and 0 < v[1] <= 232448 for v in plan.values())


# the stages that store or read the blocks pre_t and q_z have a bf16 form
BF16_FORMS = ("stage_triplet_pre", "stage_triplet_att", "stage_node_pre",
              "stage_att_pos")


def launched(names, block_dtype):
    """The kernels a setting launches with blocks of `block_dtype`."""
    if block_dtype == torch.float32:
        return names
    return tuple(n + "_bf16" if n in BF16_FORMS else n for n in names)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(MERGES))
def test_bf16_block_wrappers_count_launches(cuda, setting):
    """With bf16 blocks each setting launches the bf16 forms of the stages
    that store or read the blocks (and the float32 stages A and C), once a
    layer; the stack agrees with the plain stack with bf16 blocks (1e-3:
    the two float32 B1 results may round to neighbouring bf16 values)."""
    merge_node_pre, merge_pos, names = MERGES[setting]
    names = launched(names, torch.bfloat16)
    case = kc.flagship_case(device=cuda, seed=2, **SHAPES["small"])
    ls.reset_launch_counts()
    packed = {k: torch.stack([v, v]) for k, v in case["w"].items()}
    args = (packed, case["h"], case["x"], case["hb"], case["t"], case["d"])
    got = ls.layer_stack(*args, merge_node_pre=merge_node_pre,
                         merge_pos=merge_pos, block_dtype=torch.bfloat16)
    assert ls.LAUNCHES == {k: 2 * (k in names) for k in ls.LAUNCHES}
    ref = ls.layer_stack(*args, use_kernels=False,
                         block_dtype=torch.bfloat16)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("block_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32_blocks", "bf16_blocks"])
@pytest.mark.parametrize("setting", sorted(MERGES))
def test_layer_stack_fn_gradients(cuda, setting, block_dtype):
    """`LayerStackFn` (kernels forward, one plain layer at a time backward)
    gives the gradients of autograd through the whole plain float32 stack,
    for the packed weights, h, x, hb, e_w and phore_norm (1e-4 of each
    leaf's largest gradient). With bf16 blocks the backward is
    straight-through: it recomputes in float32, so the same bound holds."""
    merge_node_pre, merge_pos, names = MERGES[setting]
    names = launched(names, block_dtype)
    case = kc.flagship_case(device=cuda, seed=5, **SHAPES["small"])
    g = torch.Generator().manual_seed(0)
    grads = []
    for fused in (True, False):
        packed = {k: torch.stack([v, 0.9 * v]).requires_grad_(True)
                  for k, v in case["w"].items()}
        ins = [case[k].clone().requires_grad_(True) for k in ("h", "x", "hb")]
        t = dict(case["t"])
        for k in ("e_w", "phore_norm"):
            t[k] = t[k].clone().requires_grad_(True)
        ls.reset_launch_counts()
        if fused:
            out = ls.make_layer_stack_grad(
                case["d"], merge_node_pre, merge_pos,
                block_dtype=block_dtype)(packed, *ins, t)
            assert ls.LAUNCHES == {k: 2 * (k in names) for k in ls.LAUNCHES}
        else:
            out = ls.layer_stack(packed, *ins, t, case["d"],
                                 use_kernels=False)
        g.manual_seed(0)
        loss = sum((o * torch.randn(o.shape, generator=g).to(cuda)).sum()
                   for o in out)
        leaves = ins + [t["e_w"], t["phore_norm"]] + [
            packed[k] for k in sorted(packed)]
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for a, b in zip(*grads):
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0
            continue
        assert torch.isfinite(a).all()
        scale = max(float(b.abs().max()), 1e-3)
        assert float((a - b).abs().max()) / scale < 1e-4


@pytest.mark.cuda
def test_layer_stack_fn_has_no_fallback(cuda, monkeypatch):
    """On CUDA tensors a kernel that cannot be loaded raises; the plain
    stages do not run in its place."""
    from phoregen_tpu_torch.ops import _build

    def no_library(name="layer_stack"):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "load", no_library)
    case = kc.flagship_case(device=cuda, seed=6, **SHAPES["small"])
    packed = {k: v[None].clone().requires_grad_(True)
              for k, v in case["w"].items()}
    ls.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc"):
        ls.make_layer_stack_grad(case["d"], True, True)(
            packed, case["h"], case["x"], case["hb"], case["t"])
    assert not any(ls.LAUNCHES.values())


@pytest.mark.cuda
def test_wrappers_reject_mismatched_shapes(cuda):
    case = kc.flagship_case(device=cuda, seed=3, **SHAPES["small"])
    w, t, d, h, x, hb = (case[k] for k in ("w", "t", "d", "h", "x", "hb"))
    ls.reset_launch_counts()
    with pytest.raises(ValueError, match="hb"):
        ls.stage_node(w, h, x, hb[:, 1:], t, d)
    with pytest.raises(ValueError, match="pre_t"):
        pre_t, q_z = ls.stage_triplet_pre_plain(w, h, x, hb, t, d)
        ls.stage_triplet_att(w, hb, pre_t[..., 1:, :], q_z, t, d)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES


# one change to the `small` dims each; None: the dims as they are
DIM_CHANGES = [None, dict(H=18), dict(H=516, heads=4), dict(H=20, heads=3),
               dict(H=24, heads=3), dict(Wt=6), dict(Wt=36), dict(Wt=0),
               dict(Wt=32), dict(H=132, heads=33), dict(K8=33), dict(K8=0),
               dict(K8=32), dict(K=17), dict(K=16), dict(K=0), dict(NL=513),
               dict(NL=512), dict(NL=1)]


@pytest.mark.cuda
def test_dim_rules_agree_with_the_kernel_library(cuda):
    """`_check_dims` refuses exactly the dims that `dims_ok` in
    csrc/layer_stack.cu refuses (asked through `ls_launch_plan`), so the
    two copies of the rule cannot drift apart unnoticed."""
    import ctypes
    import dataclasses

    from phoregen_tpu_torch.ops import _build
    plan = _build.load().ls_launch_plan
    plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    small = ls.StackDims(NP=6, NL=8, K=4, K8=3, H=16, heads=2, Wt=8)
    flagship = dataclasses.replace(small, NP=96, NL=80, K=32, K8=32, H=128,
                                   heads=16, Wt=32)
    cases = [flagship] + [dataclasses.replace(small, **(c or {}))
                          for c in DIM_CHANGES]
    for d in cases:
        dims = (ctypes.c_int * 8)(2, d.NP, d.NL, d.K, d.K8, d.H, d.heads,
                                  d.Wt)
        out = (ctypes.c_int * 20)()
        try:
            ls._check_dims(d)
            python_takes = True
        except ValueError:
            python_takes = False
        assert (plan(dims, out) == 0) == python_takes, d


POOL_SHAPES = {
    "small": dict(B=2, N=8, heads=4, Wt=8),
    "ragged_tile": dict(B=3, N=13, heads=4, Wt=16),   # N % 8 != 0
    "flagship_nl32": dict(B=4, N=32),
    "flagship_n48": dict(B=2, N=48),
    "flagship_n80": dict(B=2, N=80),
    # N not a multiple of the block's 8 target atoms, a second chunk of
    # 5 sources
    "ragged_37": dict(B=3, N=37, heads=4, Wt=16),
    # three chunks of sources, heads not a multiple of 4
    "tall_83": dict(B=1, N=83, heads=6, Wt=8),
    # widths the kernel takes through the wrapper: Wt no multiple of 4
    # (zero-padded), more than 32 heads (two launches), more bands than a
    # lane's registers hold
    "odd_wt6": dict(B=2, N=13, heads=4, Wt=6),
    "heads40": dict(B=2, N=11, heads=40, Wt=8),
    "num_ang8": dict(B=2, N=13, heads=4, Wt=8, num_ang=8),
    "odd_wt18_heads36": dict(B=2, N=48, heads=36, Wt=18),
}


def _pool_args(c):
    return [c[k] for k in ("a_kj", "a_ji", "q", "pos", "mask", "w_ang",
                           "ln_scale", "ln_bias", "act", "norm",
                           "num_ang_funcs")]


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("shape", sorted(POOL_SHAPES))
def test_triplet_pool_kernel_matches_plain(cuda, shape, norm):
    case = kc.triplet_case(device=cuda, seed=1, **POOL_SHAPES[shape])
    case["norm"] = norm
    row = kc.check_triplet_pool(case, reps=1)
    assert row["ok"], (row["max_abs_err"], row["tol"])


def _holes(case):
    """Masks that are not a prefix: every third slot of graph 0 and the
    last slot of graph 1 are padding, graph 2 keeps its last slot."""
    m = case["mask"].clone()
    N = m.shape[1]
    m[0, ::3] = False
    m[1, N - 1] = False
    m[2, N - 1] = True
    return dict(case, mask=m)


def _under_three(case):
    """Graphs of 0, 1 and 2 valid atoms (the last two with padding between
    and after them): no valid triplet."""
    m = torch.zeros_like(case["mask"])
    m[1, 3] = True
    m[2, 1] = m[2, 5] = True
    return dict(case, mask=m)


def _degenerate(case):
    """Exactly collinear atoms (integer points on one line, so that every
    product is exact) and two atoms at one position, in each graph."""
    p = case["pos"].clone()
    for a, t in ((1, 1.0), (2, 2.0), (3, 3.0)):
        p[:, a] = torch.tensor([t, 2 * t, -3 * t])
    p[:, 5] = p[:, 4]
    return dict(case, pos=p, mask=torch.ones_like(case["mask"]))


POOL_MASKS = {"holes": _holes, "under_three": _under_three,
              "degenerate": _degenerate}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(POOL_MASKS))
def test_triplet_pool_kernel_edge_cases(cuda, name):
    """Within tolerance on the unmasked pairs, exactly 0 on the others,
    finite throughout; a graph without a valid triplet pools to exactly 0
    everywhere."""
    case = POOL_MASKS[name](kc.triplet_case(device=cuda, seed=6, B=3, N=37,
                                            heads=4, Wt=16))
    row = kc.check_triplet_pool(case, reps=1)
    assert row["ok"], (row["max_abs_err"], row["tol"])
    if name == "under_three":
        assert bool((pt.triplet_pool_cuda(*_pool_args(case)) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("act", sorted(pt.ACTS))
def test_triplet_pool_kernel_activations(cuda, act):
    case = kc.triplet_case(device=cuda, seed=2, **POOL_SHAPES["small"])
    case["act"] = act
    row = kc.check_triplet_pool(case, reps=1)
    assert row["ok"], (act, row["max_abs_err"])


@pytest.mark.cuda
def test_triplet_pool_counts_and_backward(cuda):
    """One launch per call with `use_pallas`; the backward recomputes
    through the plain version and matches its gradients."""
    case = kc.triplet_case(device=cuda, seed=3, **POOL_SHAPES["small"])
    args = _pool_args(case)
    grads = []
    for use_pallas in (True, False):
        ins = [a.clone().requires_grad_(True)
               if torch.is_tensor(a) and a.dtype == torch.float32 else a
               for a in args]
        pt.reset_launch_counts()
        out = pt.triplet_pool(*ins, use_pallas=use_pallas)
        assert pt.LAUNCHES["triplet_pool"] == int(use_pallas)
        (out ** 2).sum().backward()
        grads.append([a.grad for a in ins if torch.is_tensor(a)
                      and a.dtype == torch.float32])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_triplet_pool_has_no_fallback(cuda, monkeypatch):
    """With `use_pallas` and CUDA tensors a missing library raises; the
    plain version is not taken in its place."""
    from phoregen_tpu_torch.ops import _build

    def no_library(name="layer_stack"):
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(pt, "triplet_pool_plain", lambda *a, **k: pytest.fail(
        "the plain version ran in place of the kernel"))
    case = kc.triplet_case(device=cuda, seed=4, **POOL_SHAPES["small"])
    pt.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc"):
        pt.triplet_pool(*_pool_args(case), use_pallas=True)
    assert pt.LAUNCHES["triplet_pool"] == 0


@pytest.mark.cuda
def test_triplet_pool_wrapper_rejects_bad_inputs(cuda):
    case = kc.triplet_case(device=cuda, seed=5, **POOL_SHAPES["small"])
    args = _pool_args(case)
    pt.reset_launch_counts()
    with pytest.raises(ValueError, match="a_ji"):
        pt.triplet_pool_cuda(args[0], args[1][:, 1:], *args[2:])
    with pytest.raises(ValueError, match="contiguous"):
        pt.triplet_pool_cuda(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError, match="float32"):
        pt.triplet_pool_cuda(args[0].double(), *args[1:])
    with pytest.raises(NotImplementedError, match="activation"):
        pt.triplet_pool_cuda(*args[:8], "swish", True, 3)
    wide = kc.triplet_case(device=cuda, seed=5, B=1, N=5, heads=2, Wt=36)
    with pytest.raises(ValueError, match="up to 32"):
        pt.triplet_pool_cuda(*_pool_args(wide))
    with pytest.raises(ValueError, match="aligned"):
        q = torch.empty(args[2].numel() + 1, device=cuda)[1:]
        pt.triplet_pool_cuda(args[0], args[1], q.view_as(args[2]), *args[3:])
    assert pt.LAUNCHES["triplet_pool"] == 0


# ------------------------------------------------- model options, native

OPTION_PHORE = """opt_phore
AR\t1.0\t1\t1\t1.0\t2.0\t3.0\t1\t0.0\t0.0\t1.0\t0\t1
HD\t0.7\t1\t1\t-1.0\t0.5\t2.0\t0\t0.0\t0.0\t0.0\t0\t1
HY\t1.0\t1\t1\t0.5\t-1.0\t1.0\t0\t0.0\t0.0\t0.0\t0\t1
EX\t0.837\t0.5\t1\t4.0\t4.0\t4.0\t0\t0.0\t0.0\t0.0\t0\t1
$$$$
"""
OPTION_PATHS = {   # option: (model settings, fused_stack, kernels)
    "continuous": (dict(categorical_space="continuous"), "pallas2",
                   ("stage_node_pre", "stage_att_pos")),
    "no_bond": (dict(bond_diffusion=False), "pallas",
                ("stage_node", "stage_triplet_pre", "stage_triplet_att",
                 "stage_pos")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("option", sorted(OPTION_PATHS))
def test_option_paths_reach_their_kernels(cuda, option):
    """`categorical_space: continuous` through `pallas2` and
    `bond_diffusion: false` through `pallas` launch their stack's kernels
    on a short chain (and no others), and agree with the plain stages on
    the CPU on the first step's predictions."""
    import numpy as np
    from phoregen_tpu_torch.config import default_config
    from phoregen_tpu_torch.data.batching import replicate_phore
    from phoregen_tpu_torch.data.phore import parse_phore_text
    from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
    from phoregen_tpu_torch.sample.sampler import Sampler

    settings, fused, kernels = OPTION_PATHS[option]
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 32
    for k, v in dict(num_layers=2, n_heads=4, knn=4, triplet_knn=3,
                     triplet_width=8, fused_stack=fused,
                     block_knn_freeze=True).items():
        setattr(m.denoiser, k, v)
    if "categorical_space" in settings:
        m.diff.categorical_space = settings["categorical_space"]
    if "bond_diffusion" in settings:
        m.bond_diffusion = settings["bond_diffusion"]
    m.diff.num_timesteps = 10
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.finalize()
    pg = PhoreGen(cfg)
    init_params(pg.net, 0)
    pg.net.to(cuda).eval()
    sample = GenerationPipeline(pg, device=cuda).prepare_phore(
        parse_phore_text(OPTION_PHORE, "opt_phore"))
    batch = replicate_phore(sample, 3, np.asarray([7, 12, 16]), 16)
    sp = Sampler(pg, sample_steps=4)
    ls.reset_launch_counts()
    pt.reset_launch_counts()
    out = sp.sample(batch.to(cuda),
                    torch.Generator(device=cuda).manual_seed(1))
    torch.cuda.synchronize()
    launches = dict(ls.LAUNCHES, **pt.LAUNCHES)
    assert launches == {k: 4 * 2 * (k in kernels) for k in launches}
    assert (out["pred_edge"] is None) == (option == "no_bond")
    assert torch.isfinite(out["pred_pos"]).all()

    # the first step's predictions against the plain stages on the CPU
    cpu = PhoreGen(cfg)
    cpu.net.load_state_dict({k: v.cpu() for k, v in
                             pg.net.state_dict().items()})
    cpu.net.eval()
    state0 = Sampler(cpu).init_state(batch.to("cpu"),
                                     torch.Generator().manual_seed(2))
    preds = []
    for model, dev in ((pg, cuda), (cpu, "cpu")):
        s = Sampler(model, sample_steps=4)
        b = batch.to(dev)
        state = {k: None if v is None else v.to(dev)
                 for k, v in state0.items()}
        preds.append(s.step(state, 0, b, s.prepare(b), False,
                            torch.Generator(device=dev).manual_seed(3))[1])
    lm = batch.lig_mask
    for a, b in zip(preds[0][:2], preds[1][:2]):
        torch.testing.assert_close(a.cpu()[lm], b[lm], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_native_host_library_loads(cuda):
    """On the card's machine the host library builds (g++) into the
    port's build directory and is the one bond perception uses."""
    import os
    from phoregen_tpu_torch import native
    assert native.available(), native.load_error()
    assert os.path.exists(native.library_path())
    assert native.predict_bonds_native([6, 6], [[0, 0, 0], [1.5, 0, 0]]) \
        == ([[0, 1], [1, 0]], [1, 1])
