"""Hold each CUDA kernel against its plain version on the card, and time
both, at the shapes the sampling and training paths give it.

`flagship_case()` builds one layer's inputs at the flagship width (H=128,
16 heads, Wt=32, kNN 32, K8 32) for a batch of B graphs with NP phore and
NL ligand slots, from a seed, on the given device. `check_kernels(case)`
returns one row per layer-stack kernel (the four single stages and the two
merged ones): max abs/rel error against the plain version on
the same inputs, kernel and plain times (CUDA events), and the H100 bound
from the bytes the function moves and the float32 operations it needs on
the slots the case's masks leave (`flops`; `flops_all_slots` is the count
if no slot were masked): `bound_ms` with every operation at the FMA rate,
`bound_tc_ms` with the matrix products (`flops_products`) at the tensor
cores' 3xTF32 rate.
`check_kernels(case, kernels=BF16_KERNELS)` does the same for the forms of
rows 2, 3, 5 and 6 whose inter-stage blocks pre_t and q_z are bf16
(`fused_block_dtype`); `flagship_case(cutoff='hybrid')` gives the kNN
table of the hybrid cutoff (NL + K sources a ligand row).
`stage_calls(case)` gives the kernel and plain calls alone (for a tool
that times two builds of the kernels against each other).
`triplet_case()` and `check_triplet_pool()` do the same for the all-k
triplet pool (`ops/pallas_triplet.py`) at B graphs of N ligand slots.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import layer_stack as ls
from . import pallas_triplet as pt
from .knn import knn_neighbors

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores, and the effective float32 rate of error-compensated 3xTF32
# on them (495 TFLOP/s of TF32, three products for one)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32X3_FLOPS_PER_S = 495e12 / 3

KERNELS = (
    ("stage_node",
     "phoregen_tpu/ops/layer_stack.py:449 (_stage_node via _stage_pallas:1114)"),
    ("stage_triplet_pre",
     "phoregen_tpu/ops/layer_stack.py:516 (_stage_triplet_pre via "
     "_stage_pallas:1114)"),
    ("stage_triplet_att",
     "phoregen_tpu/ops/layer_stack.py:1221 (_att_pallas / "
     "_head_att_accumulate:1188)"),
    ("stage_pos",
     "phoregen_tpu/ops/layer_stack.py:629 (_stage_pos via _stage_pallas:1114)"),
    ("stage_node_pre",
     "phoregen_tpu/ops/layer_stack.py:578 (_stage_node_pre via "
     "_stage_pallas:1114)"),
    ("stage_att_pos",
     "phoregen_tpu/ops/layer_stack.py:1261 (_att_pos_pallas)"),
)
# the forms with bf16 blocks pre_t and q_z (B1 stores them rounded to
# nearest even, B2 widens them; all arithmetic float32)
BF16_KERNELS = tuple((name + "_bf16", replaces) for name, replaces in KERNELS
                     if name in ("stage_triplet_pre", "stage_triplet_att",
                                 "stage_node_pre", "stage_att_pos"))
# the kernels that read the kNN table (the hybrid cutoff's rows)
KNN_KERNELS = tuple((name, replaces) for name, replaces in KERNELS
                    if name in ("stage_node", "stage_pos", "stage_node_pre",
                                "stage_att_pos"))
SOURCE = "phoregen_tpu_torch/csrc/layer_stack.cu"
TRIPLET_REPLACES = ("phoregen_tpu/ops/pallas_triplet.py:214 "
                    "(triplet_pool_pallas -> _kernel:144)")
TRIPLET_SOURCE = "phoregen_tpu_torch/csrc/triplet_pool.cu"

# atol = rtol per kernel against its plain version. pre_t gets 5e-4: at
# nearly collinear triplets (sin^2 of the angle ~1e-6) the reference's
# angle formula, sqrt(|a|^2 |b|^2 - (a.b)^2), loses half its digits; on
# flagship inputs both the kernel and the plain version sit up to ~1.7e-4
# from a float64 evaluation there (H100, 700 W, measured by holding both
# against the plain version run in float64).
# triplet_pool gets the same 5e-4 for the same reason: its pre-features
# carry that angle, and a softmax over k and a pool follow them.
# stage_node_pre runs the same B1 body, so its pre_t keeps the 5e-4 (its
# new_h and q_z are held to 1e-4).
# The bf16-block forms keep their float32 rows' tolerances: B2 and B2 + C
# read the same bf16 blocks as their plain versions, and a block that B1
# stores is held to the float32 tolerance plus one bf16 unit in the last
# place of the larger of the two values (the two float32 results may fall
# on either side of a rounding boundary; `BLOCK_OUTPUTS`).
TOLERANCE = {"stage_node": 1e-4, "stage_triplet_pre": 5e-4,
             "stage_triplet_att": 1e-4, "stage_pos": 1e-4,
             "stage_node_pre": 5e-4, "stage_att_pos": 1e-4,
             "stage_triplet_pre_bf16": 5e-4, "stage_triplet_att_bf16": 1e-4,
             "stage_node_pre_bf16": 5e-4, "stage_att_pos_bf16": 1e-4,
             "triplet_pool": 5e-4}
# per-output override of a row's tolerance, by position in the output tuple
OUTPUT_TOL = {"stage_node_pre": (1e-4, 5e-4, 1e-4),
              "stage_node_pre_bf16": (1e-4, 5e-4, 1e-4)}
# outputs that are bf16 blocks, by position in the output tuple
BLOCK_OUTPUTS = {"stage_triplet_pre_bf16": (0, 1),
                 "stage_node_pre_bf16": (1, 2)}
# Both B1s round their float32 block to nearest even, so a stored element
# differs from the plain version's only where the two float32 results fall
# on either side of a rounding boundary: a float32 error of ~1e-6 of the
# value against a bf16 unit of 2^-8 of it makes that rare. At most this
# share of a block's elements may differ (a store that truncates differs
# on about half of them, and stays within one unit).
BLOCK_MISMATCH_SHARE = 1e-2


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |t| (8 significant bits), 0 at
    0."""
    m, e = torch.frexp(t.float().abs())
    return torch.where(m == 0, torch.zeros_like(m),
                       torch.ldexp(torch.ones_like(m), e - 8))


def _random_tree(spec, g: torch.Generator, device):
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _random_tree(v, g, device)
        elif k == "scale" or k.endswith("ln_scale"):
            out[k] = (1.0 + 0.1 * torch.randn(v, generator=g)).to(device)
        else:
            fan = v[-2] if len(v) >= 3 else 4
            out[k] = (0.3 * torch.randn(v, generator=g) / fan ** 0.5
                      ).to(device)
    return out


def flagship_case(B=16, NP=96, NL=80, H=128, heads=16, Wt=32, K=32,
                  trip_k=32, seed=0, device="cuda",
                  empty_first=False, cutoff="knn", lig_mask=None) -> Dict:
    """One layer's inputs; `empty_first` leaves graph 0 without a valid
    ligand atom (all its ligand rows are padding); `lig_mask` ([B, NL]
    bool) sets which ligand slots hold an atom, in place of the first
    n_lig of each graph. `cutoff` 'hybrid' builds
    the kNN table of the hybrid cutoff (`ops/knn.py::hybrid_neighbors`:
    ligand rows take every ligand slot and their K nearest phore points,
    NL + K columns) in place of the K nearest neighbours."""
    from ..models.denoiser import layer_param_shapes
    from .knn import hybrid_neighbors
    g = torch.Generator().manual_seed(seed)
    N = NP + NL
    fe = 93
    tree = _random_tree(layer_param_shapes(H, heads, Wt, fe, 1), g, device)
    w = ls.layer_weights(ls.pack_layer_params(tree, H, fe), 0)
    x = torch.cat([4.0 * torch.randn(B, NP, 3, generator=g),
                   2.0 * torch.randn(B, NL, 3, generator=g)], 1).to(device)
    n_lig = torch.randint(NL // 2, NL + 1, (B,), generator=g)
    if empty_first:
        n_lig[0] = 0
    n_ph = torch.randint(NP // 2, NP + 1, (B,), generator=g)
    ar_l, ar_p = torch.arange(NL), torch.arange(NP)
    lig = ar_l[None] < n_lig[:, None] if lig_mask is None \
        else torch.as_tensor(lig_mask, dtype=torch.bool).cpu()
    node_mask = torch.cat([ar_p[None] < n_ph[:, None], lig], 1).to(device)
    if cutoff == "hybrid":
        nbr_idx, nbr_mask = hybrid_neighbors(x, node_mask, NP, K)
    else:
        nbr_idx, nbr_mask = knn_neighbors(x, node_mask, K)
    K = nbr_idx.shape[-1]
    t = ls.build_block_tables(x, node_mask, nbr_idx, nbr_mask, NP, trip_k)
    is_lig = (torch.arange(N, device=device) >= NP).long()
    et = 3 - 2 * is_lig[nbr_idx] - is_lig[None, :, None]
    t["edge_type"] = torch.nn.functional.one_hot(et, 4).float().contiguous()
    t["e_w"] = torch.rand(B, N, K, generator=g).to(device)
    pn = torch.randn(B, NP, 3, generator=g)
    t["phore_norm"] = (pn / pn.norm(dim=-1, keepdim=True)).to(device)
    d = ls.StackDims(NP=NP, NL=NL, K=K, K8=min(trip_k, NL - 1),
                     H=H, heads=heads, Wt=Wt)
    h = torch.randn(B, N, H, generator=g).to(device)
    hb = torch.randn(B, NL, NL, H, generator=g).to(device)
    return dict(w=w, t=t, d=d, h=h, x=x, hb=hb, B=B)


def all_slots(d, B: int) -> Dict[str, int]:
    """The slot counts of `_work` if no mask voided anything: every kNN
    slot, every (source, destination) pair of the bond grid, every triplet.
    The most a call at these shapes could need."""
    return {"edges": B * d.N * d.K, "edges_lig": B * d.NL * d.K,
            "lig_rows": B * d.NL, "pairs": B * d.NL * d.NL,
            "trip_src": B * d.NL * d.K8,
            "trips": B * d.NL * d.NL * d.K8}


def slot_counts(t: Dict) -> Dict[str, int]:
    """The slots of one call whose results can reach an output, from the
    tables' masks (a masked slot gets a softmax weight of exactly 0, a
    padded ligand row a position update of exactly 0):
    edges      kNN slots with a valid neighbour, over all destination rows
    edges_lig  the same over the ligand rows that hold an atom (stage C)
    lig_rows   ligand rows that hold an atom
    pairs      (source, destination) pairs of the bond grid with two atoms,
               source != destination
    trip_src   (j, k) triplet sources with j an atom and k a valid source
    trips      valid triplets (`layer_stack.trip_valid`)"""
    ml = t["mask_l"]
    NP = t["nbr_mask"].shape[1] - ml.shape[1]
    count = lambda v: int(v.double().sum())
    return {"edges": count(t["nbr_mask"]),
            "edges_lig": count(t["nbr_mask"][:, NP:] * ml[..., None]),
            "lig_rows": count(ml), "pairs": count(ls._pair_mask(t)),
            "trip_src": count(t["trip_mask"] * ml[..., None]),
            "trips": count(ls.trip_valid(t))}


def _work(name: str, c: Dict, n: Dict[str, int] = None):
    """(bytes, float32 operations) one call needs (`_work_split`, its
    products and the rest together)."""
    by, products, rest = _work_split(name, c, n)
    return by, products + rest


def _work_split(name: str, c: Dict, n: Dict[str, int] = None):
    """(bytes, product operations, other operations) one call needs: every
    input read once
    and every output written once, at the tensors' full sizes; the
    operations of the products and the attention on the slots `n` that
    this call's masks leave (`slot_counts`, the default), so the bound is
    the work the data needs whatever the kernel does with masked slots.
    Work that no mask voids is counted in full: the node projections, new_h
    for every row (stage A), q_z for every pair (stage B1). The blocks
    pre_t and q_z count 2 bytes an element in the `_bf16` forms. The
    products are the matrix products whose width is a multiple of 4, which
    the kernels run on the tensor cores; the rest (single-row products,
    value columns of a width that is not, angle encodings, scores, softmax
    weights and pools) runs on the FMA pipes."""
    d, B = c["d"], c["B"]
    bb = 2 if name.endswith("_bf16") else 4    # bytes a block element
    sfx = "_bf16" if bb == 2 else ""
    N, NL, H, nh, Wt = d.N, d.NL, d.H, d.heads, d.Wt
    NP, K, K8 = d.NP, d.K, d.K8
    if n is None:
        n = slot_counts(c["t"])
    f4 = 4
    tc = lambda cols: cols % 4 == 0
    if name.startswith("stage_node_pre"):
        # A + B1 with h, x and hb read once (the weights of the two differ)
        (b1, p1, r1), (b2, p2, r2) = (_work_split(k, c, n) for k in (
            "stage_node", "stage_triplet_pre" + sfx))
        return (b1 + b2 - (B * N * (H + 3) + B * NL * NL * H) * f4,
                p1 + p2, r1 + r2)
    if name.startswith("stage_att_pos"):
        # B2 + C with hb_new written once and not read back
        (b1, p1, r1), (b2, p2, r2) = (_work_split(k, c, n) for k in (
            "stage_triplet_att" + sfx, "stage_pos"))
        return b1 + b2 - B * NL * NL * H * f4, p1 + p2, r1 + r2
    wbytes = sum(v.numel() for v in c["w"].values()) * f4
    tab = (B * N * K * (4 + 4 + 16 + 4) + B * NL * (3 + K8) * 8
           + B * NP * 12 + B * NL * 4)
    if name in ("stage_node", "stage_pos"):
        node = name == "stage_node"
        nv = H if node else nh
        edges = n["edges"] if node else n["edges_lig"]
        rows = B * N if node else n["lig_rows"]    # C updates ligand atoms
        mm = [2 * B * N * H * 10 * H,                # node projections
              2 * edges * (93 * 2 * H + H * H),      # edge k | v, k layers
              2 * n["pairs"] * (H * 2 * H + H * H)]  # the same, bond grid
        fma = [2 * rows * (H * H) * 2,               # query tail (+ lin_W)
               2 * n["lig_rows"] * H * H,            # bond-grid query
               4 * (edges + n["pairs"]) * H]         # scores + pooling
        # the value layers: H columns (A) or one a head (C)
        (mm if tc(nv) else fma).append(2 * (edges + n["pairs"]) * H * nv)
        by = (B * N * H * f4 + B * N * 3 * f4 + B * NL * NL * H * f4 + tab
              + wbytes + (B * N * H * f4 if node else B * N * 3 * f4))
        return by, sum(mm), sum(fma)
    if name.startswith("stage_triplet_pre"):
        # node projections and q_z's layer; then a_kj and a_ji (Wt columns)
        mm = [2 * B * NL * H * (2 * Wt + H), 2 * B * NL * NL * H * H]
        fma = [2 * n["trips"] * 13 * Wt]             # angle encodings
        (mm if tc(Wt) else fma).extend(
            [2 * n["trip_src"] * H * Wt, 2 * n["pairs"] * 20 * Wt])
        by = (B * N * H * f4 + B * N * 3 * f4 + B * NL * NL * H * f4
              + B * NL * K8 * 4 + wbytes
              + B * NL * NL * (K8 * Wt + H) * bb)
        return by, sum(mm), sum(fma)
    # per-head queries and the output layer; scores and pools per triplet
    mm = 2 * n["pairs"] * H * nh * Wt + 2 * n["pairs"] * nh * Wt * H
    by = (B * NL * NL * ((K8 * Wt + H) * bb + 2 * H * f4) + B * NL * K8 * 8
          + B * NL * 4 + wbytes)
    return by, mm, 4 * n["trips"] * nh * Wt


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _row(name, source, replaces, ok, got, ref, kern, plain, by, fl, reps,
         products=0):
    """One result row: errors of `got` against `ref` (tuples of tensors),
    both times, the bound from `by` bytes and `fl` operations, all at the
    FMA rate (`bound_ms`), and the bound with the `products` of them at the
    3xTF32 rate of the tensor cores (`bound_tc_ms`)."""
    tol = TOLERANCE[name]
    tols = OUTPUT_TOL.get(name, (tol,) * len(got))
    blocks = BLOCK_OUTPUTS.get(name, ())
    got, ref = [a.float() for a in got], [b.float() for b in ref]
    abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    rel_err = max(float(((a - b).abs() / (b.abs() + 1e-3)).max())
                  for a, b in zip(got, ref))

    def close(i, a, b, tl):
        if i not in blocks:
            return torch.allclose(a, b, atol=tl, rtol=tl)
        return bool(((a - b).abs() <= tl + tl * b.abs()
                     + bf16_ulp(torch.maximum(a.abs(), b.abs()))).all())
    share = max((float((a != b).float().mean())
                 for i, (a, b) in enumerate(zip(got, ref)) if i in blocks),
                default=None)
    ok = ok and all(bool(torch.isfinite(a).all()) for a in got) and all(
        close(i, a, b, tl)
        for i, (a, b, tl) in enumerate(zip(got, ref, tols))) and (
        share is None or share <= BLOCK_MISMATCH_SHARE)
    t_bytes = by / HBM_BYTES_PER_S * 1e3
    t_ops = fl / FP32_FLOPS_PER_S * 1e3
    t_tc = (products / TF32X3_FLOPS_PER_S
            + (fl - products) / FP32_FLOPS_PER_S) * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "ok": ok,
        "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
        "ms": _time_ms(kern, reps), "plain_ms": _time_ms(plain,
                                                         max(1, reps // 2)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_tc_ms": max(t_bytes, t_tc), "bytes": by, "flops": fl,
        "flops_products": products, "library_ms": None,
        "block_mismatch_share": share,
    }


def triplet_case(B=16, N=48, heads=16, Wt=32, num_ang=3, seed=0,
                 device="cuda") -> Dict:
    """Inputs of one all-k triplet pool: B graphs of N ligand slots, each
    with between N/2 and N valid atoms (the rest padding), from a seed."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    n_lig = torch.randint(N // 2, N + 1, (B,), generator=g)
    n_lig[0] = N
    mask = torch.arange(N)[None] < n_lig[:, None]
    c = dict(a_kj=r(B, N, N, Wt), a_ji=r(B, N, N, Wt),
             q=r(B, N, N, heads, Wt), pos=2.0 * r(B, N, 3), mask=mask,
             w_ang=0.3 * r(1 + 4 * num_ang, Wt), ln_scale=1.0 + 0.1 * r(Wt),
             ln_bias=0.1 * r(Wt))
    c = {k: v.to(device) for k, v in c.items()}
    c.update(act="relu", norm=True, num_ang_funcs=num_ang)
    return c


def _triplet_work(c: Dict):
    """(bytes, float32 operations) of one triplet pool on these inputs,
    both on what the mask leaves: the output written once in full (its
    zeros on masked pairs are part of the result); q(j, i), a_ji(j, i) and
    a_kj(k, j) read once on the ordered pairs of two different valid atoms
    of a graph that holds a triplet (at least three valid atoms); positions,
    mask, w_ang and LayerNorm read once; the operations of the triplets
    (angle encoding product, sum and LayerNorm, and per head the score and
    the pool)."""
    B, N, _, Wt = c["a_kj"].shape
    heads = c["q"].shape[-2]
    enc = c["w_ang"].shape[0]
    n = c["mask"].sum(-1).double()
    pairs = float((n * (n - 1) * (n >= 3)).sum())
    triplets = float((n * (n - 1) * (n - 2)).clamp(min=0).sum())
    by = 4 * (B * N * N * heads * Wt + pairs * (heads * Wt + 2 * Wt)
              + B * N * 4 + enc * Wt + 2 * Wt)
    fl = triplets * Wt * (2 * enc + 8 + 4 * heads)
    return by, fl


def check_triplet_pool(c: Dict, reps: int = 5) -> Dict:
    """The triplet-pool kernel against its plain version on the same inputs
    (compared on the (j, i) pairs the mask leaves; the others must be
    exactly 0), then both timed."""
    args = [c[k] for k in ("a_kj", "a_ji", "q", "pos", "mask", "w_ang",
                           "ln_scale", "ln_bias", "act", "norm",
                           "num_ang_funcs")]
    kern = lambda: pt.triplet_pool_cuda(*args)
    plain = lambda: pt.triplet_pool_plain(*args)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    m = c["mask"]
    N = m.shape[1]
    pair = (m[:, :, None] & m[:, None, :]
            & ~torch.eye(N, dtype=torch.bool, device=m.device))
    zero_ok = bool((got[~pair] == 0).all())
    by, fl = _triplet_work(c)
    return _row("triplet_pool", TRIPLET_SOURCE, TRIPLET_REPLACES, zero_ok,
                (got[pair],), (ref[pair],), kern, plain, by, fl, reps)


def stage_calls(c: Dict) -> Dict:
    """{kernel name: (kernel call, plain call)} of the six layer-stack
    kernels and the four bf16-block forms on the inputs of `c`; B2, C and
    B2 + C take the plain versions' outputs of the stages before them (the
    bf16 forms the plain bf16 blocks)."""
    w, t, d, h, x, hb = c["w"], c["t"], c["d"], c["h"], c["x"], c["hb"]
    bf = torch.bfloat16
    pre_r, qz_r = ls.stage_triplet_pre_plain(w, h, x, hb, t, d)
    pre_b, qz_b = ls.stage_triplet_pre_plain(w, h, x, hb, t, d, bf)
    nh_r = ls.stage_node_plain(w, h, x, hb, t, d)
    hbn_r = ls.stage_triplet_att_plain(w, hb, pre_r, qz_r, t, d)
    return {
        "stage_triplet_pre_bf16": (
            lambda: ls.stage_triplet_pre(w, h, x, hb, t, d, bf),
            lambda: ls.stage_triplet_pre_plain(w, h, x, hb, t, d, bf)),
        "stage_triplet_att_bf16": (
            lambda: ls.stage_triplet_att(w, hb, pre_b, qz_b, t, d),
            lambda: ls.stage_triplet_att_plain(w, hb, pre_b, qz_b, t, d)),
        "stage_node_pre_bf16": (
            lambda: ls.stage_node_pre(w, h, x, hb, t, d, bf),
            lambda: ls.stage_node_pre_plain(w, h, x, hb, t, d, bf)),
        "stage_att_pos_bf16": (
            lambda: ls.stage_att_pos(w, hb, pre_b, qz_b, nh_r, x, t, d),
            lambda: ls.stage_att_pos_plain(w, hb, pre_b, qz_b, nh_r, x, t,
                                           d)),
        "stage_node": (lambda: ls.stage_node(w, h, x, hb, t, d),
                       lambda: ls.stage_node_plain(w, h, x, hb, t, d)),
        "stage_triplet_pre": (
            lambda: ls.stage_triplet_pre(w, h, x, hb, t, d),
            lambda: ls.stage_triplet_pre_plain(w, h, x, hb, t, d)),
        "stage_triplet_att": (
            lambda: ls.stage_triplet_att(w, hb, pre_r, qz_r, t, d),
            lambda: ls.stage_triplet_att_plain(w, hb, pre_r, qz_r, t, d)),
        "stage_pos": (lambda: ls.stage_pos(w, nh_r, x, hbn_r, t, d),
                      lambda: ls.stage_pos_plain(w, nh_r, x, hbn_r, t, d)),
        "stage_node_pre": (
            lambda: ls.stage_node_pre(w, h, x, hb, t, d),
            lambda: ls.stage_node_pre_plain(w, h, x, hb, t, d)),
        "stage_att_pos": (
            lambda: ls.stage_att_pos(w, hb, pre_r, qz_r, nh_r, x, t, d),
            lambda: ls.stage_att_pos_plain(w, hb, pre_r, qz_r, nh_r, x, t,
                                           d)),
    }


def check_kernels(c: Dict, reps: int = 5, kernels=KERNELS) -> List[Dict]:
    """Run each of `kernels` ((name, replaces) pairs: KERNELS, BF16_KERNELS,
    KNN_KERNELS) once against its plain version on the same inputs (row
    'ok' says whether it agrees within TOLERANCE), then time both."""
    t = c["t"]
    calls = stage_calls(c)
    slots, every = slot_counts(t), all_slots(c["d"], c["B"])
    rows = []
    for name, replaces in kernels:
        kern, plain = calls[name]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name.startswith(("stage_triplet_pre", "stage_node_pre")):
            # pre_t slots of masked triplets (source slot beyond a graph's
            # atoms, k == i, j == i) are inert downstream; a masked slot may
            # repeat j itself, an exactly collinear triple whose angle is
            # ill-conditioned. Compare the triplets the attention reads.
            valid = ls.trip_valid(t)[..., None] > 0
            i = 0 if name.startswith("stage_triplet_pre") else 1
            got = (*got[:i], got[i][valid.expand_as(got[i])], *got[i + 1:])
            ref = (*ref[:i], ref[i][valid.expand_as(ref[i])], *ref[i + 1:])
        by, products, rest = _work_split(name, c, slots)
        row = _row(name, SOURCE, replaces, True, got, ref, kern, plain, by,
                   products + rest, reps, products)
        row["flops_all_slots"] = _work(name, c, every)[1]
        rows.append(row)
    return rows
