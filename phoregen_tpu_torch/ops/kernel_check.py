"""Hold each layer-stack kernel against its plain version on the card, and
time both, at the shapes the sampling path gives it.

`flagship_case()` builds one layer's inputs at the flagship width (H=128,
16 heads, Wt=32, kNN 32, K8 32) for a batch of B graphs with NP phore and
NL ligand slots, from a seed, on the given device. `check_kernels(case)`
returns one row per kernel: max abs/rel error against the plain version on
the same inputs, kernel and plain times (CUDA events), and the H100 bound
from the bytes and float32 operations the function needs.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from . import layer_stack as ls
from .knn import knn_neighbors

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores (the kernels use plain FMA)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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
)
SOURCE = "phoregen_tpu_torch/csrc/layer_stack.cu"

# atol = rtol per kernel against its plain version. pre_t gets 5e-4: at
# nearly collinear triplets (sin^2 of the angle ~1e-6) the reference's
# angle formula, sqrt(|a|^2 |b|^2 - (a.b)^2), loses half its digits; on
# flagship inputs both the kernel and the plain version sit up to ~1.7e-4
# from a float64 evaluation there (H100, 700 W, measured by holding both
# against the plain version run in float64).
TOLERANCE = {"stage_node": 1e-4, "stage_triplet_pre": 5e-4,
             "stage_triplet_att": 1e-4, "stage_pos": 1e-4}


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
                  trip_k=32, seed=0, device="cuda") -> Dict:
    from ..models.denoiser import layer_param_shapes
    g = torch.Generator().manual_seed(seed)
    N = NP + NL
    fe = 93
    tree = _random_tree(layer_param_shapes(H, heads, Wt, fe, 1), g, device)
    w = ls.layer_weights(ls.pack_layer_params(tree, H, fe), 0)
    x = torch.cat([4.0 * torch.randn(B, NP, 3, generator=g),
                   2.0 * torch.randn(B, NL, 3, generator=g)], 1).to(device)
    n_lig = torch.randint(NL // 2, NL + 1, (B,), generator=g)
    n_ph = torch.randint(NP // 2, NP + 1, (B,), generator=g)
    ar_l, ar_p = torch.arange(NL), torch.arange(NP)
    node_mask = torch.cat([ar_p[None] < n_ph[:, None],
                           ar_l[None] < n_lig[:, None]], 1).to(device)
    nbr_idx, nbr_mask = knn_neighbors(x, node_mask, K)
    t = ls.build_block_tables(x, node_mask, nbr_idx, nbr_mask, NP, trip_k)
    is_lig = (torch.arange(N, device=device) >= NP).long()
    et = 3 - 2 * is_lig[nbr_idx] - is_lig[None, :, None]
    t["edge_type"] = torch.nn.functional.one_hot(et, 4).float().contiguous()
    t["e_w"] = torch.rand(B, N, K, generator=g).to(device)
    pn = torch.randn(B, NP, 3, generator=g)
    t["phore_norm"] = (pn / pn.norm(dim=-1, keepdim=True)).to(device)
    d = ls.StackDims(NP=NP, NL=NL, K=min(K, N - 1), K8=min(trip_k, NL - 1),
                     H=H, heads=heads, Wt=Wt)
    h = torch.randn(B, N, H, generator=g).to(device)
    hb = torch.randn(B, NL, NL, H, generator=g).to(device)
    return dict(w=w, t=t, d=d, h=h, x=x, hb=hb, B=B)


def _work(name: str, c: Dict):
    """(bytes, float32 operations) one call needs: inputs read once,
    outputs written once; operations of the products and attention."""
    d, B = c["d"], c["B"]
    N, NP, NL, K, K8 = d.N, d.NP, d.NL, d.K, d.K8
    H, nh, Wt = d.H, d.heads, d.Wt
    f4 = 4
    wbytes = sum(v.numel() for v in c["w"].values()) * f4
    tab = (B * N * K * (4 + 4 + 16 + 4) + B * NL * (3 + K8) * 8
           + B * NP * 12 + B * NL * 4)
    if name in ("stage_node", "stage_pos"):
        nv = H if name == "stage_node" else nh
        rows = N if name == "stage_node" else NL    # C updates ligand rows
        fl = 2 * B * N * H * 10 * H                  # node projections
        fl += 2 * B * rows * K * (93 * 2 * H + H * H + H * nv)
        fl += 2 * B * rows * (H * H) * 2             # query tail (+ lin_W)
        fl += 2 * B * NL * NL * (H * 2 * H + H * H + H * nv)
        fl += 2 * B * NL * H * H
        fl += 4 * B * (rows * K + NL * NL) * H       # scores + pooling
        by = (B * N * H * f4 + B * N * 3 * f4 + B * NL * NL * H * f4 + tab
              + wbytes + (B * N * H * f4 if name == "stage_node"
                          else B * N * 3 * f4))
        return by, fl
    if name == "stage_triplet_pre":
        fl = (2 * B * NL * H * (2 * Wt + H) + 2 * B * NL * K8 * H * Wt
              + 2 * B * NL * NL * 20 * Wt + 2 * B * NL * NL * H * H
              + 2 * B * NL * NL * K8 * 13 * Wt)
        by = (B * N * H * f4 + B * N * 3 * f4 + B * NL * NL * H * f4
              + B * NL * K8 * 4 + wbytes
              + B * NL * NL * (K8 * Wt + H) * f4)
        return by, fl
    fl = (2 * B * NL * NL * H * nh * Wt + 4 * B * NL * NL * K8 * nh * Wt
          + 2 * B * NL * NL * nh * Wt * H)
    by = (B * NL * NL * (K8 * Wt + H + 2 * H) * f4 + B * NL * K8 * 8
          + B * NL * 4 + wbytes)
    return by, fl


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


def check_kernels(c: Dict, reps: int = 5) -> List[Dict]:
    """Run every kernel once against its plain version on the same inputs
    (row 'ok' says whether it agrees within TOLERANCE), then time both."""
    w, t, d, h, x, hb = c["w"], c["t"], c["d"], c["h"], c["x"], c["hb"]
    pre_r, qz_r = ls.stage_triplet_pre_plain(w, h, x, hb, t, d)
    nh_r = ls.stage_node_plain(w, h, x, hb, t, d)
    hbn_r = ls.stage_triplet_att_plain(w, hb, pre_r, qz_r, t, d)
    calls = {
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
    }
    rows = []
    for name, replaces in KERNELS:
        kern, plain = calls[name]
        tol = TOLERANCE[name]
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name == "stage_triplet_pre":
            # pre_t slots of masked triplets (source slot beyond a graph's
            # atoms, k == i, j == i) are inert downstream; a masked slot may
            # repeat j itself, an exactly collinear triple whose angle is
            # ill-conditioned. Compare the triplets the attention reads.
            valid = ls.trip_valid(t)[..., None] > 0
            got = (got[0][valid.expand_as(got[0])], got[1])
            ref = (ref[0][valid.expand_as(ref[0])], ref[1])
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        rel_err = max(float(((a - b).abs() / (b.abs() + 1e-3)).max())
                      for a, b in zip(got, ref))
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        ok = finite and all(torch.allclose(a, b, atol=tol, rtol=tol)
                            for a, b in zip(got, ref))
        ms = _time_ms(kern, reps)
        plain_ms = _time_ms(plain, max(1, reps // 2))
        by, fl = _work(name, c)
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = fl / FP32_FLOPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "ok": ok,
            "max_abs_err": abs_err, "max_rel_err": rel_err, "tol": tol,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": by, "flops": fl, "library_ms": None,
        })
    return rows
