"""The dense triplet bond update's kernel path (`BondUpdateTriplet.
_dense_kernel`: the prologue's bond and atom terms in PyTorch, then the
CUDA kernel of `csrc/dense_triplet.cu`) against the plain `_dense`.

On the CPU: the prologue, with the key output folded into the query and
the per-triplet loop written here as einsums over the padded grid, equals
`_dense`; the dispatch and its counter `DENSE_TRIP`. The `cuda`-marked
cases (skipped without a card) hold the kernel path against `_dense` on
every output slot and find its device time inside the `bond.triplet`
span. Imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dense_triplet_kernel.py
"""
import math

import pytest
import torch

from phoregen_tpu_torch.models import layers
from phoregen_tpu_torch.models.layers import BondUpdateTriplet
from phoregen_tpu_torch.ops import kernel_check as kc
from phoregen_tpu_torch.ops.pallas_triplet import triplet_angle, triplet_mask
from phoregen_tpu_torch.ops.rbf import (angular_encoding,
                                        angular_encoding_freq_bands,
                                        gaussian_smearing,
                                        gaussian_smearing_offsets)

# as tests/test_torch_port_dense_upstream.py: float32 sums of a few hundred
# terms taken in another order
TOL = 1e-5
H, HEADS = 128, 16


def _tree(spec, gen):
    if isinstance(spec, dict):
        return {k: _tree(v, gen) for k, v in spec.items()}
    w = torch.randn(spec, generator=gen)
    return w / spec[0] ** 0.5 if len(spec) > 1 else w / 3.0


def _inputs(counts, NL, seed, holes=()):
    """Features of graphs of `counts` atoms in NL slots (padding at the
    tail), with the slots `holes` ((graph, slot) pairs) masked too."""
    gen = torch.Generator().manual_seed(seed)
    B = len(counts)
    h = torch.randn(B, NL, H, generator=gen)
    hb = torch.randn(B, NL, NL, H, generator=gen)
    pos = 1.5 * torch.randn(B, NL, 3, generator=gen)
    mask = torch.arange(NL)[None] < torch.tensor(counts)[:, None]
    for b, k in holes:
        mask[b, k] = False
    return h, hb, pos, mask, gen


def _geometry(pos):
    rel = pos[:, :, None, :] - pos[:, None, :, :]
    dist = torch.sqrt((rel * rel).sum(-1) + 1e-12)
    return rel, gaussian_smearing(dist, *gaussian_smearing_offsets(
        fix_offset=True))


def _kernel_loop(layer, p, t, rel, mask):
    """What the kernel computes from the prologue's terms `t`, as einsums
    over the padded [B, k, j, i] grid: the key output folded into the
    query, LayerNorm in the E[(x - mu)^2] form, the softmax's sums, and the
    value output after the pool; 0 on a bond with no source."""
    B, N = mask.shape
    dh = H // HEADS
    a_kj = t["kj_a"] + t["kj_b"] + t["n_src"][:, :, None] + t["n_dst"][:, None]
    enc = angular_encoding(triplet_angle(rel[:, :, None], rel[:, None]),
                           angular_encoding_freq_bands(3)).transpose(1, 2)

    def row(name, off):
        pre = (a_kj[..., off:off + H][:, :, :, None]
               + t["ji"][..., off:off + H][:, None]
               + enc @ p[f"{name}_ang"]["kernel"])            # [B,k,j,i,H]
        if layer.norm:
            mu = pre.mean(-1, keepdim=True)
            var = ((pre - mu) ** 2).mean(-1, keepdim=True)
            pre = ((pre - mu) * torch.rsqrt(var + 1e-6)
                   * p[f"{name}_ln"]["scale"] + p[f"{name}_ln"]["bias"])
        return layer.act(pre)

    q = t["q"].reshape(B, N, N, HEADS, dh)
    q_fold = torch.einsum("bjihd,chd->bjihc", q, p["hk_out"]["kernel"]
                          .reshape(H, HEADS, dh)) / math.sqrt(dh)
    scores = torch.einsum("bkjic,bjihc->bkjih", row("hk", 0), q_fold)
    valid = triplet_mask(mask)[..., None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e9))
    e = torch.exp(scores - scores.amax(1, keepdim=True)) * valid
    den = e.sum(1)                                            # [B,j,i,heads]
    pooled = torch.einsum("bkjih,bkjic->bjihc", e, row("hv", H)) \
        / den.clamp(min=1e-30)[..., None]
    out = torch.einsum("bjihc,chd->bjihd", pooled, p["hv_out"]["kernel"]
                       .reshape(H, HEADS, dh)).reshape(B, N, N, H)
    return (out + p["hv_out"]["bias"]) * (den[..., :1] > 0)


@pytest.mark.parametrize("norm,h_node", [(True, True), (False, True),
                                         (True, False), (False, False)])
def test_prologue_and_triplet_loop_equal_dense(norm, h_node):
    """Random graphs with padding, a mask with holes, and graphs of 1, 2
    and 3 atoms: the prologue plus the kernel's loop equals `_dense`, and a
    bond with no source is exactly 0 in both."""
    counts, NL = [9, 7, 1, 2, 3, 6], 10
    h, hb, pos, mask, gen = _inputs(counts, NL, seed=11,
                                    holes=((0, 4), (5, 0)))
    layer = BondUpdateTriplet(hidden_dim=H, n_heads=HEADS, mode="dense",
                              norm=norm, include_h_node=h_node)
    p = _tree(BondUpdateTriplet.shapes(H, HEADS, norm=norm,
                                       include_h_node=h_node, mode="dense"),
              gen)
    rel, r_feat = _geometry(pos)
    with torch.no_grad():
        want = layer._dense(p, h, hb, r_feat, rel, mask)
        got = _kernel_loop(layer, p, layer._dense_prologue(p, h, hb, r_feat),
                           rel, mask)
    assert float((got - want).abs().max()) < TOL * float(want.abs().max())
    # no source: padding, j == i, graphs under three atoms
    n = mask.sum(-1)
    bonds = mask[:, :, None] & mask[:, None, :] & ~torch.eye(NL,
                                                             dtype=torch.bool)
    none = ~(bonds & (n >= 3)[:, None, None])
    assert not want[none].any() and not got[none].any()
    assert want[~none].abs().amax(-1).min() > 0


def test_dispatch_takes_dense_outside_the_kernel_and_counts_calls():
    h, hb, pos, mask, gen = _inputs([5, 3], 6, seed=2)
    p = _tree(BondUpdateTriplet.shapes(H, HEADS, mode="dense"), gen)
    layer = BondUpdateTriplet(hidden_dim=H, n_heads=HEADS, mode="dense")
    narrow = BondUpdateTriplet(hidden_dim=32, n_heads=4, mode="dense")
    p32 = _tree(BondUpdateTriplet.shapes(32, 4, mode="dense"), gen)
    bands = BondUpdateTriplet(hidden_dim=H, n_heads=HEADS, mode="dense",
                              num_ang_funcs=2)
    p_b = _tree(BondUpdateTriplet.shapes(H, HEADS, num_ang=2, mode="dense"),
                gen)
    bf = lambda tree: {k: bf(v) if isinstance(v, dict)
                       else v.to(torch.bfloat16) for k, v in tree.items()}
    grad_h = h.clone().requires_grad_(True)
    calls = [
        ("features on the CPU", layer, p, (h, hb, pos, mask), False),
        ("autograd", layer, p, (grad_h, hb, pos, mask), True),
        ("bfloat16", layer, bf(p), (h.bfloat16(), hb.bfloat16(), pos, mask),
         False),
        ("hidden_dim 32", narrow, p32, (h[..., :32], hb[..., :32], pos, mask),
         False),
        ("num_ang_funcs 2", bands, p_b, (h, hb, pos, mask), False),
    ]
    layers.DENSE_TRIP.update(kernel=0, plain=0)
    for want, layer_, tree, (h_, hb_, pos_, mask_), grad in calls:
        with torch.set_grad_enabled(grad):
            why = layer_._dense_refusal(tree, h_, hb_, pos_)
            assert why is not None and want.split()[0] in why, (want, why)
            out = layer_(tree, h_, hb_, pos_, mask_)
        assert out.shape == hb_.shape
    assert layers.DENSE_TRIP == {"kernel": 0, "plain": len(calls)}
    # the factorized mode is no dense call
    fac = BondUpdateTriplet(hidden_dim=32, n_heads=4, width=8)
    fac(_tree(BondUpdateTriplet.shapes(32, 4, width=8), gen), h[..., :32],
        hb[..., :32], pos, mask)
    assert layers.DENSE_TRIP == {"kernel": 0, "plain": len(calls)}


@pytest.mark.parametrize("norm,h_node", [(True, True), (False, True),
                                         (True, False), (False, False)])
def test_work_count_is_the_dense_cells_yardstick(norm, h_node):
    """The bound of the kernel's row counts what the dense cell's
    `triplet_roofline.sample` counts, graph by graph and in all."""
    from portbench import workcount_dense as wd
    case = kc.dense_case(B=5, N=12, seed=1, device="cpu", norm=norm,
                         include_h_node=h_node)
    n_lig = case["mask"].sum(-1).tolist()
    assert len(set(n_lig)) > 1
    assert kc._dense_work(case) == wd.layer_work(
        wd.graph_counts(n_lig), H, HEADS, include_h_node=h_node, norm=norm)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the benchmark's dense cell (B=30, NL=48, 17-35 atoms) and the largest
# bucket at N/2..N atoms; small graphs of 1-4 atoms and a mask with holes
DENSE_CASES = {
    "cell_nl48": dict(B=30, N=48, counts=[17 + (k * 18) // 29
                                          for k in range(30)]),
    "nl80": dict(B=16, N=80),
    "small": dict(B=6, N=9, counts=[1, 2, 3, 4, 9, 0]),
    # the kernel's other settings: no LayerNorm, no atom terms (the
    # prologue's repeated-row terms, row stride 0), another activation
    "small_no_norm_no_h_node": dict(B=6, N=9, counts=[1, 2, 3, 4, 9, 0],
                                    norm=False, include_h_node=False),
    "small_silu": dict(B=6, N=9, counts=[1, 2, 3, 4, 9, 0], act_fn="silu"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(DENSE_CASES))
def test_kernel_equals_dense(cuda, shape):
    case = kc.dense_case(device=cuda, seed=3, **DENSE_CASES[shape])
    if shape.startswith("small"):
        case["mask"][4, 2] = False          # a hole inside a graph
    row = kc.check_dense_triplet(case, reps=1)
    assert row["ok"], row
    path, _, plain = kc.dense_calls(case)
    with torch.no_grad():
        got, want = path(), plain()
    # every slot: exact zeros where `_dense` has them
    assert not got[want == 0].any()


@pytest.mark.cuda
def test_kernel_runs_inside_the_bond_triplet_span(cuda):
    from portbench import devspans, trace
    case = kc.dense_case(device=cuda, seed=4, B=4, N=16)
    layer, p = case["layer"], case["p"]
    args = (p, case["h"], case["h_bond"], case["pos"], case["mask"])
    layers.DENSE_TRIP.update(kernel=0, plain=0)
    with torch.no_grad():
        layer(*args)
        torch.cuda.synchronize()
        with trace.profile() as prof:
            layer(*args)
            torch.cuda.synchronize()
    assert layers.DENSE_TRIP == {"kernel": 2, "plain": 0}
    dev, _ = trace.events(prof)
    spans = [(s, e) for n, s, e in devspans.ranges(prof)
             if n == "bond.triplet"]
    kern = [(s, e) for n, s, e in dev if "dense_triplet_kernel" in n]
    assert spans and len(kern) == 1
    (ks, ke), = kern
    assert any(s <= ks and ke <= e for s, e in spans), (kern, spans)
    inside = devspans.busy_inside_us(dev, devspans.ranges(prof))
    assert inside["bond.triplet"] >= ke - ks
