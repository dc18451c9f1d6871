"""The operations and bytes of the dense triplet bond update (PhoreGen's
published `BondUpdateLayer`, `triplet_mode: dense`), counted from the atom
counts at the least any implementation needs: the yardstick of
`triplet_roofline.sample`, and its part of `mfu.sample` in a dense cell.

Only real atoms, real bonds (j != i) and real triplets (k, j, i distinct)
are counted: a padded slot costs nothing. Every term that does not depend
on the triplet is counted where it can live:

- per row (atom): the node terms of the key and value first layers
  (h(k) and h(j) projected once an atom, 2H x H each a branch) and the
  node term of the query's first layer;
- per bond: the bond-state and radial terms of both branches (k -> j and
  j -> i), the query MLP, the key branch's output projection folded into
  the query (score_h = act(pre_k) . (W_out[:, h] q_h) + q_h . b_out[h],
  so a key is never formed), and the value branch's output projection
  applied once a bond after the pool (the weights sum to 1);
- per triplet: the angle and its encoding, the angle projection of both
  branches (13 x H each), the three-term sum, LayerNorm and activation of
  both branches, one score a head (a dot over H with the folded query),
  the softmax's exponent and sums, and one weighted accumulate a head (of
  act(pre_v), H wide).

Each input and output byte is counted once: h, the bond states and the
positions of the real atoms and bonds read, the update of the real bonds
written, and the layer's parameters read once a call. The operations are
held against the TF32 tensor-core rate and the bytes against HBM
bandwidth, as `workcount.stack_roofline_s` holds the fused stack.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from . import workcount

F4 = 4
ENC = 13          # the angular encoding's width (3 frequency bands)
RBF = 20          # the radial basis' width
# a triplet's angle (the pair vectors and their norms are per bond): dot,
# cross term, sqrt, atan2, and six scaled sines and cosines
ANGLE_OPS = 20
# a LayerNorm element: mean, centre, square, sum, normalise, scale, shift;
# and the activation
LN_ACT_OPS = 8
# a head's softmax a triplet: running max, exponent, sum, scale
SOFTMAX_OPS = 4


def graph_counts(n_lig: Sequence[int]) -> Dict[str, int]:
    """Rows, bonds and triplets of real atoms, summed over the graphs."""
    n = np.asarray(n_lig, np.int64)
    return {"rows": int(n.sum()), "pairs": int((n * (n - 1)).sum()),
            "trips": int((n * (n - 1) * np.maximum(n - 2, 0)).sum())}


def layer_param_bytes(H: int, heads: int, include_h_node: bool = True,
                      norm: bool = True) -> int:
    """Bytes of one dense bond layer's parameters."""
    from .reference.layers import BondUpdateTriplet

    def count(t):
        return sum(count(v) if isinstance(v, dict) else int(np.prod(v))
                   for v in t.values())
    return F4 * count(BondUpdateTriplet.shapes(
        H, heads, norm, include_h_node, mode="dense"))


def layer_work(c: Dict[str, int], H: int, heads: int,
               include_h_node: bool = True, norm: bool = True):
    """(bytes, operations) of one call of the dense bond layer on the
    counts `c` (`graph_counts`)."""
    rows, pairs, trips = c["rows"], c["pairs"], c["trips"]
    hn = include_h_node
    ln = LN_ACT_OPS if norm else 1
    # per row: h(k) and h(j) terms of both branches, h(i) term of the query
    row_ops = (2 * 2 * H * H * 2 + 2 * H * H) if hn else 0
    # per bond, both branches: bond state and radial k -> j, radial j -> i
    pair_ops = 2 * 2 * ((H + RBF) * H + RBF * H)
    pair_ops += 2 * RBF * 4 + 8                  # distance, radial basis
    # the query MLP (bond-state term of its first layer, norm, second)
    pair_ops += 2 * H * H + ln * H + 2 * H * H
    pair_ops += 2 * H * H + 2 * H                # key output folded into q
    pair_ops += 2 * H * H + H                  # value output, after the pool
    trip_ops = (ANGLE_OPS + 2 * (2 * ENC * H + 2 * H + ln * H)
                + 2 * H * heads + SOFTMAX_OPS * heads + 2 * H * heads)
    ops = rows * row_ops + pairs * pair_ops + trips * trip_ops
    by = F4 * (rows * (H + 3) + 2 * pairs * H) + layer_param_bytes(
        H, heads, include_h_node, norm)
    return by, ops


def _dims(cfg: Dict):
    dcfg = cfg["model"]["denoiser"]
    return (dcfg["hidden_dim"], dcfg["n_heads"], dcfg["h_node_in_bond_net"],
            dcfg["norm"], dcfg["num_layers"] * dcfg["num_blocks"])


def roofline_s(cfg: Dict, n_lig: Sequence[int], peaks: Dict) -> float:
    """The least time the chip could take for one step's dense bond
    layers: per layer the larger of bytes over the memory bandwidth and
    operations over the TF32 tensor-core rate, times the layers."""
    H, heads, hn, norm, layers = _dims(cfg)
    by, ops = layer_work(graph_counts(n_lig), H, heads, hn, norm)
    return layers * max(by / peaks["hbm_bytes_per_s"],
                        ops / peaks["tf32_flops_per_s"])


def network_ops(cfg: Dict, NP: int, NL: int, n_lig: Sequence[int],
                n_phore: Sequence[int], steps_per_pool: int) -> float:
    """Operations of one denoiser evaluation with the dense bond layer:
    `workcount.network_ops` (node and position stages, embeddings, heads,
    phore encoder) with the factorized triplet stages B1 and B2 replaced
    by the dense layer's count."""
    m = cfg["model"]
    H, heads, hn, norm, layers = _dims(cfg)
    d = workcount.dims_for(m["denoiser"], NP, NL)
    n = workcount.slots(n_lig, n_phore, d)
    ops = workcount.network_ops(d, n, layers, m["num_atom_classes"],
                                m["num_bond_classes"], m["diff"]["time_dim"],
                                n_phore, steps_per_pool)
    ops -= layers * sum(sum(workcount.stage_work(st, d, n, 0)[1:])
                        for st in ("stage_triplet_pre", "stage_triplet_att"))
    return ops + layers * layer_work(graph_counts(n_lig), H, heads, hn,
                                     norm)[1]
