"""The operations and bytes a step needs, counted from its shapes: the
yardstick of the roofline shares and the `mfu` metrics.

The four attention stages follow the program's own counts
(`phoregen_tpu_torch/ops/kernel_check.py::slot_counts` and `_work_split`,
as of the benchmark's first version), with every term on the slots the
masks leave: each input byte that can reach an output read once and each
such output byte written once, and the operations of those slots. A
padded row, pair or triplet costs nothing, so no kernel that skips
padding can beat the count. With every slot real (`full_slots`) the
counts are the program's, but for stage B1 reading only the ligand rows
of h and x. The slots follow from the atom counts alone (a kNN row of a
real node has min(K, n - 1) real sources, padded rows none), so the count
needs no table of the program. The weights are counted at the layer's
parameter count (the program's kernels read a repacked copy of the same
numbers).

The rest of the network (embeddings, the global edge weight, the heads
and, once a pool, the phore self-encoder) is counted by the formulas of
`network_ops`. Every count is the same whatever path computes the work.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

F4 = 4


@dataclasses.dataclass(frozen=True)
class Dims:
    NP: int
    NL: int
    K: int
    K8: int
    H: int = 128
    heads: int = 16
    Wt: int = 32

    @property
    def N(self) -> int:
        return self.NP + self.NL


def dims_for(dcfg: Dict, NP: int, NL: int) -> Dims:
    """The stage shapes of a denoiser configuration at NP phore and NL
    ligand slots (kNN width clamped to N - 1, triplet width to NL - 1)."""
    return Dims(NP=NP, NL=NL, K=min(dcfg["knn"], NP + NL - 1),
                K8=min(dcfg["triplet_knn"], NL - 1), H=dcfg["hidden_dim"],
                heads=dcfg["n_heads"], Wt=dcfg["triplet_width"])


def slots(n_lig: Sequence[int], n_phore: Sequence[int], d: Dims
          ) -> Dict[str, int]:
    """The slots whose results can reach an output, per graph summed
    (the program's `slot_counts` on tables of these masks, and the rows
    that hold an atom or a phore point)."""
    nl = np.asarray(n_lig, np.int64)
    npc = np.asarray(n_phore, np.int64)
    nv = nl + npc
    k = np.minimum(d.K, np.maximum(nv - 1, 0))
    s = np.minimum(d.K8, np.maximum(nl - 1, 0))
    return {"edges": int((nv * k).sum()), "edges_lig": int((nl * k).sum()),
            "lig_rows": int(nl.sum()), "pairs": int((nl * (nl - 1)).sum()),
            "trip_src": int((nl * s).sum()),
            "trips": int((nl * s * np.maximum(nl - 2, 0)).sum()),
            "rows": int(nv.sum()), "phore_rows": int(npc.sum())}


def full_slots(d: Dims, B: int) -> Dict[str, int]:
    """Every slot of the tensors counted as real: the program's counts of
    the bytes at the tensors' full sizes."""
    return {"edges": B * d.N * d.K, "edges_lig": B * d.NL * d.K,
            "lig_rows": B * d.NL, "pairs": B * d.NL * d.NL,
            "trip_src": B * d.NL * d.K8, "trips": B * d.NL * d.NL * d.K8,
            "rows": B * d.N, "phore_rows": B * d.NP}


def layer_weight_bytes(d: Dims, fe: int = 93) -> int:
    """Bytes of one attention layer's parameters."""
    from .reference.denoiser import layer_param_shapes

    def count(t):
        return sum(count(v) if isinstance(v, dict) else int(np.prod(v))
                   for v in t.values())
    return F4 * count(layer_param_shapes(d.H, d.heads, d.Wt, fe))


def stage_work(name: str, d: Dims, n: Dict[str, int], wbytes: int):
    """(bytes, product operations, other operations) of one call of a
    stage (`stage_node`, `stage_triplet_pre`, `stage_triplet_att`,
    `stage_pos`, the merged `stage_node_pre` and `stage_att_pos`, and the
    `_bf16` forms whose blocks pre_t and q_z take 2 bytes an element), on
    the slots `n` (`slots`)."""
    bb = 2 if name.endswith("_bf16") else 4
    sfx = "_bf16" if bb == 2 else ""
    H, nh, Wt = d.H, d.heads, d.Wt
    f4 = F4
    rows, lig, pairs, trips = (n["rows"], n["lig_rows"], n["pairs"],
                               n["trips"])
    tc = lambda cols: cols % 4 == 0
    if name.startswith("stage_node_pre"):
        # A + B1 with B1's reads of h, x and hb shared with A's
        (b1, p1, r1), (b2, p2, r2) = (stage_work(k, d, n, wbytes) for k in (
            "stage_node", "stage_triplet_pre" + sfx))
        return (b1 + b2 - (lig * (H + 3) + pairs * H) * f4,
                p1 + p2, r1 + r2)
    if name.startswith("stage_att_pos"):
        # B2 + C with hb_new written once and not read back
        (b1, p1, r1), (b2, p2, r2) = (stage_work(k, d, n, wbytes) for k in (
            "stage_triplet_att" + sfx, "stage_pos"))
        return b1 + b2 - pairs * H * f4, p1 + p2, r1 + r2
    tab = (n["edges"] * (4 + 4 + 16 + 4) + lig * 3 * 8 + n["trip_src"] * 8
           + n["phore_rows"] * 12 + lig * 4)
    if name in ("stage_node", "stage_pos"):
        node = name == "stage_node"
        nv = H if node else nh
        edges = n["edges"] if node else n["edges_lig"]
        mm = [2 * rows * H * 10 * H,                 # node projections
              2 * edges * (93 * 2 * H + H * H),      # edge k | v, k layers
              2 * pairs * (H * 2 * H + H * H)]       # the same, bond grid
        fma = [2 * (rows if node else lig) * (H * H) * 2,  # query tail
               2 * lig * H * H,                      # bond-grid query
               4 * (edges + pairs) * H]              # scores + pooling
        # the value layers: H columns (A) or one a head (C)
        (mm if tc(nv) else fma).append(2 * (edges + pairs) * H * nv)
        by = (rows * H * f4 + rows * 3 * f4 + pairs * H * f4 + tab + wbytes
              + (rows * H * f4 if node else rows * 3 * f4))
        return by, sum(mm), sum(fma)
    if name.startswith("stage_triplet_pre"):
        # node projections and q_z's layer; then a_kj and a_ji (Wt columns)
        mm = [2 * lig * H * (2 * Wt + H), 2 * pairs * H * H]
        fma = [2 * trips * 13 * Wt]                  # angle encodings
        (mm if tc(Wt) else fma).extend(
            [2 * n["trip_src"] * H * Wt, 2 * pairs * 20 * Wt])
        by = (lig * (H + 3) * f4 + pairs * H * f4 + n["trip_src"] * 4
              + wbytes + (trips * Wt + pairs * H) * bb)
        return by, sum(mm), sum(fma)
    mm = 2 * pairs * H * nh * Wt + 2 * pairs * nh * Wt * H
    by = ((trips * Wt + pairs * H) * bb + 2 * pairs * H * f4
          + n["trip_src"] * 8 + lig * 4 + wbytes)
    return by, mm, 4 * trips * nh * Wt


# the stages one layer runs on each path; the module path and the
# all-plain stacks compute the same four stages' mathematics
STAGES = {"pallas": ("stage_node", "stage_triplet_pre", "stage_triplet_att",
                     "stage_pos"),
          "pallas3": ("stage_node_pre", "stage_triplet_att", "stage_pos"),
          "pallas2": ("stage_node_pre", "stage_att_pos")}
FOUR = STAGES["pallas"]


def stack_roofline_s(path: str, block_dtype: str, d: Dims,
                     n: Dict[str, int], layers: int, peaks: Dict) -> float:
    """The least time the chip could take for one step's attention
    stages on a fused-stack path: per stage call the larger of bytes over
    the memory bandwidth and operations over the TF32 tensor-core rate,
    summed over the stages and layers. None on a path without stage
    kernels."""
    if path not in STAGES:
        return None
    sfx = "_bf16" if block_dtype == "bfloat16" else ""
    wb = layer_weight_bytes(d)
    total = 0.0
    for st in STAGES[path]:
        name = st + sfx if st in ("stage_triplet_pre", "stage_triplet_att",
                                  "stage_node_pre", "stage_att_pos") else st
        by, pr, rest = stage_work(name, d, n, wb)
        total += max(by / peaks["hbm_bytes_per_s"],
                     (pr + rest) / peaks["tf32_flops_per_s"])
    return layers * total


def network_ops(d: Dims, n: Dict[str, int], layers: int,
                num_atom_classes: int, num_bond_classes: int, time_dim: int,
                n_phore: Sequence[int], steps_per_pool: int) -> float:
    """Operations of one denoiser evaluation: the four stages of every
    layer, the node and bond embeddings, the global edge weight MLP on
    the kNN edges, the node and bond heads on the slots with atoms, and
    the phore self-encoder (once a pool, spread over its steps)."""
    H, td = d.H, time_dim
    ops = layers * sum(sum(stage_work(st, d, n, 0)[1:]) for st in FOUR)
    ops += 2 * n["lig_rows"] * num_atom_classes * (H - td)     # node emb
    ops += 2 * n["pairs"] * num_bond_classes * (H - td)        # bond emb
    ops += 2 * n["edges"] * (20 * H + H)                       # e_w MLP
    ops += 2 * n["lig_rows"] * (H * H + H * num_atom_classes)  # node head
    ops += 2 * n["pairs"] * (H * H + H * num_bond_classes)     # bond head
    # phore self-encoder over its dense pairs (k, v of 2H + 1 inputs,
    # q, the 18-wide input embedding), once a pool
    npairs = float(sum(int(p) * int(p) for p in n_phore))
    nrows = float(sum(int(p) for p in n_phore))
    enc = (2 * npairs * ((2 * H + 1) * 2 * H + 2 * H * H)
           + 2 * nrows * (H * H * 2 + 18 * H) + 4 * npairs * H)
    return ops + enc / steps_per_pool
