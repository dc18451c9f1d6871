"""Fused whole-layer-stack execution of the denoiser: four stages per layer.

Counterpart of `phoregen_tpu/ops/layer_stack.py::layer_stack_pallas`. Each
attention layer runs four stages, each a hand-written CUDA kernel on the
card (`csrc/layer_stack.cu`) with a plain PyTorch version beside it:

    stage_node         <- _stage_pallas o _stage_node         (A: new h)
    stage_triplet_pre  <- _stage_pallas o _stage_triplet_pre  (B1: pre_t, q_z)
    stage_triplet_att  <- _att_pallas / _head_att_accumulate  (B2: new hb)
    stage_pos          <- _stage_pallas o _stage_pos          (C: new x)

and, merged two by two (`layer_stack(merge_node_pre=, merge_pos=)`, the
`fused_stack` values 'pallas3' and 'pallas2'):

    stage_node_pre     <- _stage_pallas o _stage_node_pre     (A + B1)
    stage_att_pos      <- _att_pos_pallas                     (B2 + C)

The kernels want H and Wt to be multiples of 4 (`_check_dims`). A wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises. `LAUNCHES` counts kernel launches per stage.
On the card, stages A and C (and the merged entries that hold them) take
the queries of their kNN-edge and bond-grid attentions folded into the key
layers (score = LN(pre_k) @ W_kq + b_kq, exact algebra), formed in one
grid-wide phase before the stage's main kernel (`node_pos_query_kernel`);
the plain versions compute the unfolded scores.

`block_dtype` (`fused_block_dtype`) bfloat16 stores the inter-stage blocks
pre_t and q_z in bf16 between B1 (or A + B1) and B2 (or B2 + C), as
`layer_stack_pallas(block_dtype=jnp.bfloat16)` does: the producer computes
in float32 and rounds to nearest even, the consumer widens, all arithmetic
is float32; the kernels have `_bf16` entries for it and their own launch
counts. The backward passes straight through the rounding. The JAX
package's other meaning of the same key, bf16 carries and products on
'xla2', is the plain stages on carries in bf16: they compute in the dtype
of h and hb (positions, geometry and softmaxes float32).

`run_stack` is the one entry the denoiser calls: `FUSED_STACKS` maps each
`fused_stack` value to its driver.

`make_layer_stack_grad` makes the stack trainable: kernels forward,
backward by recomputing one layer at a time through the plain stages
(`LayerStackFn`), as the JAX package's custom VJP recomputes through
`layer_stack_xla`; on CUDA tensors that recompute is one captured CUDA
graph, replayed once a layer (`STACK_GRAPH` counts replays, eager
recomputes and captures).

Differences from the TPU layout, kept in the plain versions too so the two
can be compared element for element:
- tables are INDEX tables (nbr_idx, trip_idx, lig3_idx and masks), not the
  TPU's one-hot selection matrices;
- pre_t is laid out [B, j, i, K8, Wt] (the flat (b, j, i)-major layout), so
  one (j, i) pair's K8 x Wt tile is contiguous; the JAX kernel writes
  [B, K8, j, i, Wt]; q_z is [B, j, i, H].
Math kept: LayerNorm as E[x^2] - mu^2, masked softmax with
(1 - mask) * -1e9 and a denominator floor of 1.0, the 1e-12 clamp of the
squared cross product, atan2 for the triplet angle (the TPU used a
polynomial accurate to ~1e-5 rad).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from .knn import knn_neighbors
from .rbf import (angular_encoding, angular_encoding_freq_bands,
                  gaussian_smearing, gaussian_smearing_offsets)

LN_EPS = 1e-6
NEG_INF = -1e9
CROSS_SQ_EPS = 1e-12

# kernel launches by stage; the `_bf16` keys count the forms that store or
# read bf16 blocks pre_t and q_z
LAUNCHES = {"stage_node": 0, "stage_triplet_pre": 0, "stage_triplet_att": 0,
            "stage_pos": 0, "stage_node_pre": 0, "stage_att_pos": 0,
            "stage_triplet_pre_bf16": 0, "stage_triplet_att_bf16": 0,
            "stage_node_pre_bf16": 0, "stage_att_pos_bf16": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class StackDims:
    NP: int
    NL: int
    K: int      # block knn width
    K8: int     # triplet knn width
    H: int
    heads: int
    Wt: int
    num_ang: int = 3

    @property
    def N(self):
        return self.NP + self.NL


# --------------------------------------------------------------------------
# per-block tables
# --------------------------------------------------------------------------

def build_block_tables(x, node_mask, nbr_idx, nbr_mask, num_phore: int,
                       trip_k: int) -> Dict[str, torch.Tensor]:
    """Index tables for one block, built once from the block-start
    positions. x [B,N,3]; node_mask [B,N]; nbr_idx/nbr_mask [B,N,K].

    One ligand kNN of width max(3, K8) serves both the dire 3-NN centroid
    set (its first 3 columns, nearest first) and the triplet sources;
    `trip_k` is clamped to NL-1 like the kNN itself."""
    NP = num_phore
    NL = x.shape[1] - NP
    trip_k = min(trip_k, NL - 1)
    mask_l = node_mask[:, NP:].to(torch.bool)
    idx_m, mask_m = knn_neighbors(x[:, NP:], mask_l, max(3, trip_k))
    f32, i32 = torch.float32, torch.int32
    return {
        "nbr_idx": nbr_idx.to(i32).contiguous(),
        "nbr_mask": nbr_mask.to(f32).contiguous(),
        "lig3_idx": idx_m[..., :3].to(i32).contiguous(),
        "lig3_mask": mask_m[..., :3].to(f32).contiguous(),
        "trip_idx": idx_m[..., :trip_k].to(i32).contiguous(),
        "trip_mask": mask_m[..., :trip_k].to(f32).contiguous(),
        "mask_l": mask_l.to(f32).contiguous(),
    }


# --------------------------------------------------------------------------
# per-layer weight packing
# --------------------------------------------------------------------------

def _mlp_parts(t):
    return (t["Dense_0"]["kernel"], t["Dense_0"]["bias"],
            t["LayerNorm_0"]["scale"], t["LayerNorm_0"]["bias"],
            t["Dense_1"]["kernel"], t["Dense_1"]["bias"])


def pack_layer_params(raw, hidden: int, fe: int) -> Dict[str, torch.Tensor]:
    """Stacked per-layer param tree -> packed matrices (leading dim L).

    `raw` is the tree under `denoiser.layers.layer` (every leaf [L, ...]);
    `fe` = knn edge-feature width (93 with direction_match). Keys follow the
    JAX package's packing for what the four stages read, plus the merged
    node-projection operands the kernels use (`nodeA_W`, `nodeB_W`,
    `nodeC_W`: every projection of one node-feature tensor in one matrix;
    `nodeAB_W` = [nodeA_W | nodeB_W] for the merged A + B1 kernel).

    Every output is built with torch ops on the given leaves, so under
    autograd the packed tensors carry gradients back to the parameters."""
    H = hidden

    def cat(arrs, dim):
        return torch.cat([a.float() for a in arrs], dim=dim).contiguous()

    out: Dict[str, torch.Tensor] = {}
    nle, ple = raw["node_layer_with_edge"], raw["pos_layer_with_edge"]
    nlb, plb = raw["node_layer_with_bond"], raw["pos_layer_with_bond"]
    k_hk, k_hv = _mlp_parts(nle["hk"]), _mlp_parts(nle["hv"])
    k_xk, k_xv = _mlp_parts(ple["xk"]), _mlp_parts(ple["xv"])
    out["e_W"] = cat([k[0][:, :fe] for k in (k_hk, k_hv, k_xk, k_xv)], 2)
    out["e_b"] = cat([k[1] for k in (k_hk, k_hv, k_xk, k_xv)], 1)
    # node projections: [i-term k | i-term v | j-term k | j-term v]
    out["e_Wn_h"] = cat([k_hk[0][:, fe:fe + H], k_hv[0][:, fe:fe + H],
                         k_hk[0][:, fe + H:], k_hv[0][:, fe + H:]], 2)
    out["e_Wn_nh"] = cat([k_xk[0][:, fe:fe + H], k_xv[0][:, fe:fe + H],
                          k_xk[0][:, fe + H:], k_xv[0][:, fe + H:]], 2)
    out["e_ln_s"] = torch.stack([k[2] for k in (k_hk, k_hv, k_xk, k_xv)], 1
                                ).float().contiguous()       # [L,4,H]
    out["e_ln_b"] = torch.stack([k[3] for k in (k_hk, k_hv, k_xk, k_xv)], 1
                                ).float().contiguous()
    out["e_k2"] = torch.stack([k_hk[4], k_hv[4]], 1).float().contiguous()
    out["e_b2"] = torch.stack([k_hk[5], k_hv[5]], 1).float().contiguous()
    out["e_xk2"] = k_xk[4].float().contiguous()             # [L,H,H]
    out["e_xk2b"] = k_xk[5].float().contiguous()
    out["e_xv2"] = k_xv[4].float().contiguous()             # [L,H,heads]
    out["e_xv2b"] = k_xv[5].float().contiguous()

    b_hk, b_hv = _mlp_parts(nlb["hk"]), _mlp_parts(nlb["hv"])
    b_xk, b_xv = _mlp_parts(plb["xk"]), _mlp_parts(plb["xv"])
    out["b_W"] = cat([k[0][:, :H] for k in (b_hk, b_hv)], 2)   # [L,H,2H]
    out["b_b"] = cat([k[1] for k in (b_hk, b_hv)], 1)
    # [dst-term k | dst-term v | src-term k | src-term v]
    out["b_Wn"] = cat([b_hk[0][:, H:2 * H], b_hv[0][:, H:2 * H],
                       b_hk[0][:, 2 * H:], b_hv[0][:, 2 * H:]], 2)
    out["b_ln_s"] = torch.stack([b_hk[2], b_hv[2]], 1).float().contiguous()
    out["b_ln_b"] = torch.stack([b_hk[3], b_hv[3]], 1).float().contiguous()
    out["b_k2"] = torch.stack([b_hk[4], b_hv[4]], 1).float().contiguous()
    out["b_b2"] = torch.stack([b_hk[5], b_hv[5]], 1).float().contiguous()
    out["p_W"] = cat([k[0][:, :H] for k in (b_xk, b_xv)], 2)
    out["p_b"] = cat([k[1] for k in (b_xk, b_xv)], 1)
    out["p_Wn"] = cat([b_xk[0][:, H:2 * H], b_xv[0][:, H:2 * H],
                       b_xk[0][:, 2 * H:], b_xv[0][:, 2 * H:]], 2)
    out["p_ln_s"] = torch.stack([b_xk[2], b_xv[2]], 1).float().contiguous()
    out["p_ln_b"] = torch.stack([b_xk[3], b_xv[3]], 1).float().contiguous()
    out["p_xk2"] = b_xk[4].float().contiguous()
    out["p_xk2b"] = b_xk[5].float().contiguous()
    out["p_xv2"] = b_xv[4].float().contiguous()
    out["p_xv2b"] = b_xv[5].float().contiguous()

    # query MLPs in the order (node-knn hq, node-bond hq, pos-knn xq,
    # pos-bond xq)
    qs = [_mlp_parts(nle["hq"]), _mlp_parts(nlb["hq"]),
          _mlp_parts(ple["xq"]), _mlp_parts(plb["xq"])]
    for name, i in (("q_W0", 0), ("q_b0", 1), ("q_ln_s", 2), ("q_ln_b", 3),
                    ("q_W1", 4), ("q_b1", 5)):
        out[name] = torch.stack([q[i] for q in qs], 1).float().contiguous()

    bond = raw["bond_layer"]
    tkj = bond["tf_kj"]["kernel"]                           # [L,3H+20,Wt]
    out["t_Whb"] = tkj[:, :H].float().contiguous()
    out["t_Wr"] = tkj[:, H:H + 20].float().contiguous()
    out["t_Wn"] = cat([tkj[:, H + 20:2 * H + 20], tkj[:, 2 * H + 20:]], 2)
    out["t_b"] = bond["tf_kj"]["bias"].float().contiguous()
    out["t_Wji"] = bond["tf_ji"]["kernel"].float().contiguous()
    out["t_Wang"] = bond["tf_ang_w"].float().contiguous()
    out["t_ln_s"] = bond["tf_ln_scale"].float().contiguous()
    out["t_ln_b"] = bond["tf_ln_bias"].float().contiguous()
    tq = _mlp_parts(bond["tf_q"])
    out["tq_Whb"] = tq[0][:, :H].float().contiguous()
    out["tq_Wi"] = tq[0][:, H:].float().contiguous()
    out["tq_b0"] = tq[1].float().contiguous()
    out["tq_ln_s"] = tq[2].float().contiguous()
    out["tq_ln_b"] = tq[3].float().contiguous()
    L = tq[5].shape[0]
    Wt = bond["tf_ln_scale"].shape[-1]
    nh = tq[5].shape[-1] // Wt
    out["t_out_W"] = bond["tf_out"]["kernel"].float().reshape(
        L, nh, Wt, H).contiguous()                          # [L,h,Wt,H]
    out["t_out_b"] = bond["tf_out"]["bias"].float().contiguous()
    out["tq_W1"] = tq[4].float().reshape(L, H, nh, Wt).permute(
        0, 2, 1, 3).contiguous()                            # [L,h,H,Wt]
    out["tq_b1"] = tq[5].float().reshape(L, nh, Wt).contiguous()

    out["dire_W"] = raw["dire_embedding"]["kernel"].float().contiguous()
    out["dire_b"] = raw["dire_embedding"]["bias"].float().contiguous()
    out["lin_W"] = raw["lin_node"]["kernel"].float().contiguous()
    out["lin_b"] = raw["lin_node"]["bias"].float().contiguous()

    q_W0 = out["q_W0"]
    out["nodeA_W"] = cat([out["e_Wn_h"], q_W0[:, 0], q_W0[:, 1],
                          out["b_Wn"]], 2)                  # [L,H,10H]
    out["nodeC_W"] = cat([out["e_Wn_nh"], q_W0[:, 2], q_W0[:, 3],
                          out["p_Wn"]], 2)                  # [L,H,10H]
    out["nodeB_W"] = cat([out["t_Wn"], out["tq_Wi"]], 2)    # [L,H,2Wt+H]
    out["nodeAB_W"] = cat([out["nodeA_W"], out["nodeB_W"]], 2)
    return out


# --------------------------------------------------------------------------
# plain PyTorch stages (batched over graphs)
# --------------------------------------------------------------------------

def _ln(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _softmax_masked(scores, maskf, dim):
    s = scores + (1.0 - maskf) * NEG_INF
    m = s.amax(dim=dim, keepdim=True).detach()
    e = torch.exp(s - m) * maskf
    return e / torch.clamp(e.sum(dim=dim, keepdim=True), min=1.0)


def _gather_rows(v, idx):
    """v [B,M,F], idx [B,...] -> [B,...,F] (v[b, idx[b, ...]])."""
    B = v.shape[0]
    flat = idx.reshape(B, -1).long()
    out = torch.gather(v, 1, flat[..., None].expand(-1, -1, v.shape[-1]))
    return out.reshape(*idx.shape, v.shape[-1])


_RBF_OFFSETS, _RBF_COEFF = gaussian_smearing_offsets(fix_offset=True)


# the tables' device copies are made once (`ops/rbf.py::_table`): a copy
# from numpy synchronizes, which a captured layer (`_LayerGraph`) may not
# hold
def _rbf(dist):
    return gaussian_smearing(dist, _RBF_OFFSETS, _RBF_COEFF)


def _angular(theta, num_ang: int):
    return angular_encoding(theta, angular_encoding_freq_bands(num_ang))


def _qmlp(z, s, b, W1, b1):
    return torch.relu(_ln(z, s, b)) @ W1 + b1


def _knn_edge_prefeat(w, x, t, d: StackDims, lo: int, hi: int):
    """First-layer pre-activations (columns [lo, hi) of e_W) of the kNN
    edge MLPs and the relative vectors rel = x[dst] - x[src] (masked
    sources read as 0, as the TPU's masked one-hot gather does). The
    features are geometry (float32) cast to the weights' dtype, which is
    the carries'."""
    NP = d.NP
    wdt = w["e_W"].dtype
    mk = t["nbr_mask"][..., None]                             # [B,N,K,1]
    rel = x[:, :, None, :] - _gather_rows(x, t["nbr_idx"]) * mk
    dist = torch.sqrt((rel * rel).sum(-1) + 1e-12)
    rbf = _rbf(dist)                                          # [B,N,K,20]
    pos_l = x[:, NP:]
    l3 = _gather_rows(pos_l, t["lig3_idx"]) * t["lig3_mask"][..., None]
    cnt = torch.clamp(t["lig3_mask"].sum(-1, keepdim=True), min=1.0)
    neib = l3.sum(2) / cnt - pos_l
    comb = torch.cat([t["phore_norm"], neib], 1)              # [B,N,3]
    v1 = _gather_rows(comb, t["nbr_idx"]) * mk
    v2 = comb[:, :, None, :]
    v3 = -rel
    dire3 = torch.stack([(v1 * v2).sum(-1), (v1 * v3).sum(-1),
                         (v2 * v3).sum(-1)], -1)
    dire9 = dire3.to(wdt) @ w["dire_W"] + w["dire_b"]
    et = t["edge_type"]                                       # [B,N,K,4]
    trbf = (et[..., :, None] * rbf[..., None, :]).flatten(-2)  # [B,N,K,80]
    feat = torch.cat([trbf, et, dire9], -1).to(wdt)           # [B,N,K,93]
    return feat @ w["e_W"][:, lo:hi] + w["e_b"][lo:hi], rel


def stage_node_plain(w, h, x, hb, t, d: StackDims):
    """Stage A: kNN-edge and bond-grid node attention -> new_h [B,N,H],
    in h's dtype (the softmaxes float32, as their masks are)."""
    B, N, H = h.shape
    NP, NL, K, nh = d.NP, d.NL, d.K, d.heads
    dh = H // nh
    e_pre, _ = _knn_edge_prefeat(w, x, t, d, 0, 2 * H)
    nproj = h @ w["e_Wn_h"]                                   # [B,N,4H]
    pre = (e_pre + _gather_rows(nproj[..., 2 * H:], t["nbr_idx"])
           * t["nbr_mask"][..., None].to(h.dtype) + nproj[:, :, None, :2 * H])
    k = torch.relu(_ln(pre[..., :H], w["e_ln_s"][0], w["e_ln_b"][0]))
    v = torch.relu(_ln(pre[..., H:], w["e_ln_s"][1], w["e_ln_b"][1]))
    k = k @ w["e_k2"][0] + w["e_b2"][0]
    v = (v @ w["e_k2"][1] + w["e_b2"][1]) * t["e_w"][..., None].to(h.dtype)
    q = _qmlp(h @ w["q_W0"][0] + w["q_b0"][0], w["q_ln_s"][0],
              w["q_ln_b"][0], w["q_W1"][0], w["q_b1"][0])
    sc = (k.reshape(B, N, K, nh, dh) * q.reshape(B, N, 1, nh, dh)).sum(-1) \
        / float(np.sqrt(dh))
    al = _softmax_masked(sc, t["nbr_mask"][..., None], 2)
    out_e = (al[..., None] * v.reshape(B, N, K, nh, dh)).sum(2).reshape(
        B, N, H)

    h_l = h[:, NP:]
    nproj_b = h_l @ w["b_Wn"]                                 # [B,NL,4H]
    pre_b = (hb @ w["b_W"] + w["b_b"] + nproj_b[:, None, :, :2 * H]
             + nproj_b[:, :, None, 2 * H:])                   # [B,s,d,2H]
    k_b = torch.relu(_ln(pre_b[..., :H], w["b_ln_s"][0], w["b_ln_b"][0]))
    v_b = torch.relu(_ln(pre_b[..., H:], w["b_ln_s"][1], w["b_ln_b"][1]))
    k_b = k_b @ w["b_k2"][0] + w["b_b2"][0]
    v_b = v_b @ w["b_k2"][1] + w["b_b2"][1]
    q_b = _qmlp(h_l @ w["q_W0"][1] + w["q_b0"][1], w["q_ln_s"][1],
                w["q_ln_b"][1], w["q_W1"][1], w["q_b1"][1])
    sc_b = (k_b.reshape(B, NL, NL, nh, dh)
            * q_b.reshape(B, 1, NL, nh, dh)).sum(-1) / float(np.sqrt(dh))
    al_b = _softmax_masked(sc_b, _pair_mask(t)[..., None], 1)
    out_b = (al_b[..., None] * v_b.reshape(B, NL, NL, nh, dh)).sum(1
                                                                   ).reshape(
        B, NL, H)
    out_b = torch.cat([out_b.new_zeros(B, NP, H), out_b], 1)
    upd = (out_e + out_b).to(h.dtype) @ w["lin_W"]
    if h.dtype == torch.float32:
        return h + (upd + w["lin_b"])
    # the residual, then the bias: the JAX package's bf16 stack rounds in
    # that order (`_stage_a`); float32 keeps its own, which the kernels and
    # the backward's recompute are held to
    return h + upd + w["lin_b"]


def _pair_mask(t):
    ml = t["mask_l"]
    NL = ml.shape[1]
    eye = torch.eye(NL, dtype=ml.dtype, device=ml.device)
    return ml[:, :, None] * ml[:, None, :] * (1.0 - eye)


def stage_triplet_pre_plain(w, h, x, hb, t, d: StackDims,
                            block_dtype=torch.float32):
    """Stage B1: head-independent triplet features, computed in h's dtype
    and stored in `block_dtype` (a bf16 block of float32 carries is the
    float32 one rounded to nearest even, as XLA's convert and the kernel's
    store round it). Returns (pre_t [B,j,i,K8,Wt], q_z [B,j,i,H])."""
    NP, Wt = d.NP, d.Wt
    pos_l, h_l = x[:, NP:], h[:, NP:]
    rel_l = pos_l[:, :, None, :] - pos_l[:, None, :, :]     # [B,x,i]=x-i
    r_feat = _rbf(torch.sqrt((rel_l * rel_l).sum(-1) + 1e-12)).to(h.dtype)
    npj = h_l @ w["t_Wn"]                                    # [B,NL,2Wt]
    a_kj = (hb @ w["t_Whb"] + r_feat @ w["t_Wr"] + w["t_b"]
            + npj[:, :, None, :Wt] + npj[:, None, :, Wt:])   # [B,k,j,Wt]
    a_ji = r_feat @ w["t_Wji"]                               # [B,j,i,Wt]
    q_z = torch.relu(_ln(hb @ w["tq_Whb"] + (h_l @ w["tq_Wi"])[:, None]
                         + w["tq_b0"], w["tq_ln_s"], w["tq_ln_b"]))

    tidx = t["trip_idx"].long()                              # [B,j,K8]
    B, NL, K8 = tidx.shape
    bi = torch.arange(B, device=x.device)[:, None, None]
    ji = torch.arange(NL, device=x.device)[None, :, None]
    a_kj_sel = a_kj[bi, tidx, ji]                            # [B,j,K8,Wt]
    pos_k = _gather_rows(pos_l, tidx)                        # [B,j,K8,3]
    rel_ki = pos_k[:, :, None] - pos_l[:, None, :, None]     # [B,j,i,K8,3]
    dot = (rel_l[:, :, :, None] * rel_ki).sum(-1)            # [B,j,i,K8]
    njsq = (rel_l * rel_l).sum(-1)[..., None]
    nksq = (rel_ki * rel_ki).sum(-1)
    cross = torch.sqrt(torch.clamp(njsq * nksq - dot * dot,
                                   min=CROSS_SQ_EPS))
    enc = _angular(torch.atan2(cross, dot), d.num_ang).to(h.dtype)
    pre = a_kj_sel[:, :, None] + a_ji[:, :, :, None] + enc @ w["t_Wang"]
    pre_t = torch.relu(_ln(pre, w["t_ln_s"], w["t_ln_b"]))
    return pre_t.to(block_dtype), q_z.to(block_dtype)


def trip_valid(t):
    """[B,j,i,K8] float: source k of j is valid, i and j are valid atoms,
    k != i and j != i."""
    tidx, tm, ml = t["trip_idx"].long(), t["trip_mask"], t["mask_l"]
    NL = ml.shape[1]
    ar = torch.arange(NL, device=ml.device)
    neq_ki = (tidx[:, :, None, :] != ar[None, None, :, None]).to(ml.dtype)
    neq_ji = (ar[:, None] != ar[None, :]).to(ml.dtype)[None, :, :, None]
    return (tm[:, :, None, :] * ml[:, None, :, None] * ml[:, :, None, None]
            * neq_ki * neq_ji)


def stage_triplet_att_plain(w, hb, pre_t, q_z, t, d: StackDims):
    """Stage B2: per-head softmax over the K8 triplet sources and the pool
    -> hb + triplet update [B,NL,NL,H], in hb's dtype: the blocks pre_t
    and q_z are read in it (bf16 blocks of float32 carries are widened),
    the softmax and the pool are float32."""
    pre_t, q_z = pre_t.to(hb.dtype), q_z.to(hb.dtype)
    q = torch.einsum("bjic,hcw->bjihw", q_z, w["tq_W1"]) + w["tq_b1"]
    sc = torch.einsum("bjikw,bjihw->bjikh", pre_t, q) * (
        1.0 / float(np.sqrt(d.Wt)))
    al = _softmax_masked(sc, trip_valid(t)[..., None], 3)
    pooled = torch.einsum("bjikh,bjikw->bjihw", al, pre_t.to(al.dtype))
    return hb + (torch.einsum("bjihw,hwc->bjic", pooled.to(hb.dtype),
                              w["t_out_W"])
                 + w["t_out_b"])


def stage_pos_plain(w, new_h, x, hb_new, t, d: StackDims):
    """Stage C: kNN-edge and bond-grid position updates -> x_new [B,N,3]
    (float32; the features in new_h's dtype)."""
    B, N, H = new_h.shape
    NP, NL, K, nh = d.NP, d.NL, d.K, d.heads
    dh = H // nh
    e_pre, rel = _knn_edge_prefeat(w, x, t, d, 2 * H, 4 * H)
    nproj = new_h @ w["e_Wn_nh"]
    pre = (e_pre + _gather_rows(nproj[..., 2 * H:], t["nbr_idx"])
           * t["nbr_mask"][..., None].to(new_h.dtype)
           + nproj[:, :, None, :2 * H])
    xk = torch.relu(_ln(pre[..., :H], w["e_ln_s"][2], w["e_ln_b"][2]))
    xv = torch.relu(_ln(pre[..., H:], w["e_ln_s"][3], w["e_ln_b"][3]))
    xk = xk @ w["e_xk2"] + w["e_xk2b"]
    xv = (xv @ w["e_xv2"] + w["e_xv2b"]) * t["e_w"][..., None].to(new_h.dtype)
    xq = _qmlp(new_h @ w["q_W0"][2] + w["q_b0"][2], w["q_ln_s"][2],
               w["q_ln_b"][2], w["q_W1"][2], w["q_b1"][2])
    sc = (xk.reshape(B, N, K, nh, dh) * xq.reshape(B, N, 1, nh, dh)).sum(-1) \
        / float(np.sqrt(dh))
    al = _softmax_masked(sc, t["nbr_mask"][..., None], 2)
    w_e = (al * xv).sum(-1, keepdim=True) / nh               # [B,N,K,1]
    dx_edge = (w_e * rel).sum(2)

    pos_l, nh_l = x[:, NP:], new_h[:, NP:]
    nproj_p = nh_l @ w["p_Wn"]
    pre_p = (hb_new @ w["p_W"] + w["p_b"] + nproj_p[:, None, :, :2 * H]
             + nproj_p[:, :, None, 2 * H:])
    pk = torch.relu(_ln(pre_p[..., :H], w["p_ln_s"][0], w["p_ln_b"][0]))
    pv = torch.relu(_ln(pre_p[..., H:], w["p_ln_s"][1], w["p_ln_b"][1]))
    pk = pk @ w["p_xk2"] + w["p_xk2b"]
    pv = pv @ w["p_xv2"] + w["p_xv2b"]                       # [B,s,d,heads]
    pq = _qmlp(nh_l @ w["q_W0"][3] + w["q_b0"][3], w["q_ln_s"][3],
               w["q_ln_b"][3], w["q_W1"][3], w["q_b1"][3])
    sc_p = (pk.reshape(B, NL, NL, nh, dh)
            * pq.reshape(B, 1, NL, nh, dh)).sum(-1) / float(np.sqrt(dh))
    al_p = _softmax_masked(sc_p, _pair_mask(t)[..., None], 1)
    rel_bond = pos_l[:, None, :, :] - pos_l[:, :, None, :]   # [s,d] = d - s
    w_p = (al_p * pv).sum(-1, keepdim=True) / nh
    dx_bond = (w_p * rel_bond).sum(1)                         # [B,NL,3]
    dx = dx_edge + torch.cat([torch.zeros_like(dx_edge[:, :NP]), dx_bond], 1)
    lig = torch.cat([t["mask_l"].new_zeros(B, NP), t["mask_l"]], 1)
    return x + dx * lig[..., None]


def stage_node_pre_plain(w, h, x, hb, t, d: StackDims,
                         block_dtype=torch.float32):
    """Merged stage A + B1 (`_stage_node_pre`): (new_h, pre_t, q_z)."""
    return (stage_node_plain(w, h, x, hb, t, d),
            *stage_triplet_pre_plain(w, h, x, hb, t, d, block_dtype))


def stage_att_pos_plain(w, hb, pre_t, q_z, new_h, x, t, d: StackDims):
    """Merged stage B2 + C (`_att_pos_pallas`): the triplet attention over
    all heads, then the position update on the finished bond grid.
    Returns (hb_new, x_new)."""
    hb_new = stage_triplet_att_plain(w, hb, pre_t, q_z, t, d)
    return hb_new, stage_pos_plain(w, new_h, x, hb_new, t, d)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_TABLE_ARGS = ("nbr_idx", "nbr_mask", "edge_type", "e_w", "phore_norm",
               "lig3_idx", "lig3_mask", "mask_l")
_NODE_W = ("nodeA_W", "e_W", "e_b", "dire_W", "dire_b", "e_ln_s", "e_ln_b",
           "e_k2", "e_b2", "q_b0", "q_ln_s", "q_ln_b", "q_W1", "q_b1", "b_W",
           "b_b", "b_ln_s", "b_ln_b", "b_k2", "b_b2", "lin_W", "lin_b")
_POS_W = ("nodeC_W", "e_W", "e_b", "dire_W", "dire_b", "e_ln_s", "e_ln_b",
          "e_xk2", "e_xk2b", "e_xv2", "e_xv2b", "q_b0", "q_ln_s", "q_ln_b",
          "q_W1", "q_b1", "p_W", "p_b", "p_ln_s", "p_ln_b", "p_xk2", "p_xk2b",
          "p_xv2", "p_xv2b")
_TRIP_PRE_W = ("nodeB_W", "t_Whb", "t_Wr", "t_b", "t_Wji", "t_Wang",
               "t_ln_s", "t_ln_b", "tq_Whb", "tq_b0", "tq_ln_s", "tq_ln_b")
_TRIP_ATT_W = ("tq_W1", "tq_b1", "t_out_W", "t_out_b")


# The kernels read these one float at a time, so a layer's slice of them
# may start off a 16-byte boundary (27 and 9 floats a layer; `heads` floats
# where heads is no multiple of 4). Every other tensor is loaded 16 bytes
# at a time somewhere and must be aligned so.
_SCALAR_READ = frozenset({"dire_W", "dire_b", "e_xv2b", "p_xv2b"})


def _ptr(tensor, name, dtype=torch.float32):
    if not tensor.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if tensor.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if name not in _SCALAR_READ and tensor.data_ptr() % 16:
        raise ValueError(f"{name}: expected 16-byte aligned storage (the "
                         f"kernels load 16 bytes at a time)")
    return tensor.data_ptr()


# element type of the inter-stage blocks pre_t and q_z -> suffix of the C
# entries that take it (`fused_block_dtype`)
BLOCK_ENTRY = {torch.float32: "", torch.bfloat16: "_bf16"}
_BLOCKS = ("pre_t", "q_z")


def _launch(entry: str, named, d: StackDims, B: int,
            block_dtype=torch.float32):
    from . import _build
    if block_dtype not in BLOCK_ENTRY:
        raise TypeError(f"{entry}: blocks of {block_dtype} are not built "
                        f"(float32 or bfloat16)")
    lib = _build.load()
    ptrs = []
    for name, ten in named:
        dt = torch.int32 if name in ("nbr_idx", "lig3_idx", "trip_idx") \
            else block_dtype if name in _BLOCKS else torch.float32
        ptrs.append(_ptr(ten, name, dt))
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dims = (ctypes.c_int * 8)(B, d.NP, d.NL, d.K, d.K8, d.H, d.heads, d.Wt)
    stream = torch.cuda.current_stream().cuda_stream
    entry += BLOCK_ENTRY[block_dtype] if any(
        name in _BLOCKS for name, _ in named) else ""
    rc = getattr(lib, entry)(arr, len(ptrs), dims, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


# what `csrc/layer_stack.cu` takes (its `dims_ok`): 16-byte loads need
# widths that are multiples of 4, a warp holds the K8 sources and the Wt
# features of a triplet tile and the heads of a softmax, a block of 512
# threads a row of H features and a column of NL sources
MAX_THREADS = 512
_DIM_RULES = (
    ("H", lambda d: d.H % 4 == 0 and d.H % d.heads == 0
     and 4 <= d.H <= MAX_THREADS,
     "a multiple of 4 and of heads, at most 512"),
    ("Wt", lambda d: d.Wt % 4 == 0 and 4 <= d.Wt <= 32,
     "a multiple of 4 from 4 to 32"),
    ("heads", lambda d: 1 <= d.heads <= 32, "from 1 to 32"),
    ("K8", lambda d: 1 <= d.K8 <= 32, "from 1 to 32"),
    ("K", lambda d: 1 <= d.K <= d.H, "from 1 to H"),
    ("NL", lambda d: 1 <= d.NL <= MAX_THREADS, "from 1 to 512"),
)


def _check_dims(d: StackDims):
    """Raise, naming the dimension, for dims the kernels do not take."""
    for name, ok, why in _DIM_RULES:
        if not ok(d):
            raise ValueError(f"{name}={getattr(d, name)}: the layer-stack "
                             f"kernels take {name} {why} ({d})")


def _check_shapes(d: StackDims, B: int, t, **named):
    """The kernels index by `d`; a tensor of another shape would be read
    out of bounds, so raise before launching."""
    _check_dims(d)
    want = {"h": (B, d.N, d.H), "x": (B, d.N, 3),
            "hb": (B, d.NL, d.NL, d.H), "pre_t": (B, d.NL, d.NL, d.K8, d.Wt),
            "q_z": (B, d.NL, d.NL, d.H), "nbr_idx": (B, d.N, d.K),
            "trip_idx": (B, d.NL, d.K8)}
    named.update((k, t[k]) for k in ("nbr_idx", "trip_idx"))
    for name, ten in named.items():
        if tuple(ten.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(ten.shape)}, expected "
                             f"{want[name]} for {d}")


def _node_scratch(d: StackDims, B: int, PW: int, device):
    """Stage A's scratch: the node projections [B * N, PW], then its
    queries folded into the key layers (`node_pos_query_kernel`): the kNN
    edges' [B * N, H + 1, heads] (every node), then the bond grid's
    [B * NL, H + 1, heads] (the ligand rows; a padded one gets none and
    the kernel reads none)."""
    fs = (d.H + 1) * d.heads
    return torch.empty(B * d.N * PW + B * (d.N + d.NL) * fs, device=device)


def stage_node(w, h, x, hb, t, d: StackDims):
    """Stage A; CUDA kernel for CUDA tensors, plain version on the CPU.
    On the card the queries of both attentions come folded into their key
    layers from one grid-wide phase before the main kernel
    (`node_pos_query_kernel`, as stage C's)."""
    if not h.is_cuda:
        return stage_node_plain(w, h, x, hb, t, d)
    B = h.shape[0]
    _check_shapes(d, B, t, h=h, x=x, hb=hb)
    out = torch.empty_like(h)
    P = _node_scratch(d, B, 10 * d.H, h.device)
    named = ([("h", h), ("x", x), ("hb", hb), ("out", out), ("P", P)]
             + [(k, t[k]) for k in _TABLE_ARGS] + [(k, w[k]) for k in _NODE_W])
    _launch("ls_stage_node", named, d, B)
    LAUNCHES["stage_node"] += 1
    return out


def stage_triplet_pre(w, h, x, hb, t, d: StackDims,
                      block_dtype=torch.float32):
    """Stage B1; CUDA kernel for CUDA tensors, plain version on the CPU.
    The blocks pre_t and q_z are stored in `block_dtype`."""
    if not h.is_cuda:
        return stage_triplet_pre_plain(w, h, x, hb, t, d, block_dtype)
    B = h.shape[0]
    _check_shapes(d, B, t, h=h, x=x, hb=hb)
    pre_t = torch.empty(B, d.NL, d.NL, d.K8, d.Wt, device=h.device,
                        dtype=block_dtype)
    q_z = torch.empty(B, d.NL, d.NL, d.H, device=h.device, dtype=block_dtype)
    PB = torch.empty(B * d.NL, 2 * d.Wt + d.H, device=h.device)
    named = ([("h", h), ("x", x), ("hb", hb), ("pre_t", pre_t), ("q_z", q_z),
              ("PB", PB), ("trip_idx", t["trip_idx"])]
             + [(k, w[k]) for k in _TRIP_PRE_W])
    _launch("ls_stage_trip_pre", named, d, B, block_dtype)
    LAUNCHES["stage_triplet_pre" + BLOCK_ENTRY[block_dtype]] += 1
    return pre_t, q_z


def stage_triplet_att(w, hb, pre_t, q_z, t, d: StackDims):
    """Stage B2; CUDA kernel for CUDA tensors, plain version on the CPU.
    Reads blocks of pre_t's element type (q_z must have it too)."""
    if not hb.is_cuda:
        return stage_triplet_att_plain(w, hb, pre_t, q_z, t, d)
    B = hb.shape[0]
    _check_shapes(d, B, t, hb=hb, pre_t=pre_t, q_z=q_z)
    out = torch.empty_like(hb)
    named = ([("hb", hb), ("pre_t", pre_t), ("q_z", q_z), ("out", out),
              ("trip_idx", t["trip_idx"]), ("trip_mask", t["trip_mask"]),
              ("mask_l", t["mask_l"])] + [(k, w[k]) for k in _TRIP_ATT_W])
    _launch("ls_stage_trip_att", named, d, B, pre_t.dtype)
    LAUNCHES["stage_triplet_att" + BLOCK_ENTRY[pre_t.dtype]] += 1
    return out


def _pos_scratch(d: StackDims, B: int, device):
    """Stage C's scratch: the node projections [B * N, 10 H], then the
    queries folded into the key layers [B * NL, 2, H + 1, heads] (one per
    ligand row and attention; `node_pos_query_kernel`)."""
    return torch.empty(B * d.N * 10 * d.H
                       + B * d.NL * 2 * (d.H + 1) * d.heads, device=device)


def stage_pos(w, new_h, x, hb_new, t, d: StackDims):
    """Stage C; CUDA kernel for CUDA tensors, plain version on the CPU."""
    if not new_h.is_cuda:
        return stage_pos_plain(w, new_h, x, hb_new, t, d)
    B = new_h.shape[0]
    _check_shapes(d, B, t, h=new_h, x=x, hb=hb_new)
    out = torch.empty_like(x)
    P = _pos_scratch(d, B, x.device)
    named = ([("new_h", new_h), ("x", x), ("hb", hb_new), ("out", out),
              ("P", P)] + [(k, t[k]) for k in _TABLE_ARGS]
             + [(k, w[k]) for k in _POS_W])
    _launch("ls_stage_pos", named, d, B)
    LAUNCHES["stage_pos"] += 1
    return out


def stage_node_pre(w, h, x, hb, t, d: StackDims, block_dtype=torch.float32):
    """Merged stage A + B1; one C entry for CUDA tensors (one node
    projection phase for both roles, then B1's grid, A's folded queries
    and A's grid, each with its own shared memory), plain version on the
    CPU. The blocks are stored in `block_dtype`. Returns (new_h, pre_t,
    q_z)."""
    if not h.is_cuda:
        return stage_node_pre_plain(w, h, x, hb, t, d, block_dtype)
    B = h.shape[0]
    _check_shapes(d, B, t, h=h, x=x, hb=hb)
    new_h = torch.empty_like(h)
    pre_t = torch.empty(B, d.NL, d.NL, d.K8, d.Wt, device=h.device,
                        dtype=block_dtype)
    q_z = torch.empty(B, d.NL, d.NL, d.H, device=h.device, dtype=block_dtype)
    P = _node_scratch(d, B, 11 * d.H + 2 * d.Wt, h.device)
    named = ([("h", h), ("x", x), ("hb", hb), ("new_h", new_h), ("P", P)]
             + [(k, t[k]) for k in _TABLE_ARGS]
             + [("nodeAB_W", w["nodeAB_W"])]
             + [(k, w[k]) for k in _NODE_W[1:]]
             + [("pre_t", pre_t), ("q_z", q_z), ("trip_idx", t["trip_idx"])]
             + [(k, w[k]) for k in _TRIP_PRE_W[1:]])
    _launch("ls_stage_node_pre", named, d, B, block_dtype)
    LAUNCHES["stage_node_pre" + BLOCK_ENTRY[block_dtype]] += 1
    return new_h, pre_t, q_z


def stage_att_pos(w, hb, pre_t, q_z, new_h, x, t, d: StackDims):
    """Merged stage B2 + C; one CUDA kernel for CUDA tensors (a block per
    (graph, destination) finishes its whole column of the new bond grid in
    one pass over the weights and feeds it to the position update), plain
    version on the CPU. Reads blocks of pre_t's element type.
    Returns (hb_new, x_new)."""
    if not hb.is_cuda:
        return stage_att_pos_plain(w, hb, pre_t, q_z, new_h, x, t, d)
    B = hb.shape[0]
    _check_shapes(d, B, t, h=new_h, x=x, hb=hb, pre_t=pre_t, q_z=q_z)
    hb_new = torch.empty_like(hb)
    x_new = torch.empty_like(x)
    P = _pos_scratch(d, B, x.device)
    named = ([("new_h", new_h), ("x", x), ("hb", hb), ("x_new", x_new),
              ("P", P)] + [(k, t[k]) for k in _TABLE_ARGS]
             + [(k, w[k]) for k in _POS_W]
             + [("pre_t", pre_t), ("q_z", q_z), ("hb_new", hb_new),
                ("trip_idx", t["trip_idx"]), ("trip_mask", t["trip_mask"])]
             + [(k, w[k]) for k in _TRIP_ATT_W])
    _launch("ls_stage_att_pos", named, d, B, pre_t.dtype)
    LAUNCHES["stage_att_pos" + BLOCK_ENTRY[pre_t.dtype]] += 1
    return hb_new, x_new


def layer_weights(packed: Dict[str, torch.Tensor], l: int):
    return {k: v[l] for k, v in packed.items()}


def _layer(w, h, x, hb, t, d: StackDims, use_kernels: bool,
           merge_node_pre: bool, merge_pos: bool, block_dtype=torch.float32):
    """One attention layer -> (new_h, x_new, hb_new); the inter-stage
    blocks pre_t and q_z are stored in `block_dtype`."""
    if not use_kernels:
        # the merged plain versions are compositions of these four
        new_h = stage_node_plain(w, h, x, hb, t, d)
        pre_t, q_z = stage_triplet_pre_plain(w, h, x, hb, t, d, block_dtype)
        hb_new = stage_triplet_att_plain(w, hb, pre_t, q_z, t, d)
        return new_h, stage_pos_plain(w, new_h, x, hb_new, t, d), hb_new
    if merge_node_pre:
        new_h, pre_t, q_z = stage_node_pre(w, h, x, hb, t, d, block_dtype)
    else:
        new_h = stage_node(w, h, x, hb, t, d)
        pre_t, q_z = stage_triplet_pre(w, h, x, hb, t, d, block_dtype)
    if merge_pos:
        hb_new, x_new = stage_att_pos(w, hb, pre_t, q_z, new_h, x, t, d)
    else:
        hb_new = stage_triplet_att(w, hb, pre_t, q_z, t, d)
        x_new = stage_pos(w, new_h, x, hb_new, t, d)
    return new_h, x_new, hb_new


def layer_stack(packed: Dict[str, torch.Tensor], h, x, hb,
                tables: Dict[str, torch.Tensor], dims: StackDims,
                use_kernels: bool = True, merge_node_pre: bool = False,
                merge_pos: bool = False, remat: bool = False,
                block_dtype=torch.float32):
    """h [B,N,H]; x [B,N,3]; hb [B,NL,NL,H]; tables from
    `build_block_tables` plus 'edge_type' [B,N,K,4], 'e_w' [B,N,K] and
    'phore_norm' [B,NP,3]. Runs the stages layer by layer, as
    `layer_stack_pallas` does: four dispatches a layer, three with
    `merge_node_pre` ('pallas3'), two with `merge_pos` as well ('pallas2').
    With `use_kernels` false it runs the plain stages on any device (the
    counterpart of `layer_stack_xla`), differentiable by autograd; `remat`
    then recomputes each layer in the backward (`torch.utils.checkpoint`)
    instead of keeping its O(NL^2 K8) intermediates. `block_dtype`
    (`fused_block_dtype`) is the element type the inter-stage blocks pre_t
    and q_z are stored in between B1 and B2; the stages compute in the
    dtype of h and hb (float32 from every caller but `run_stack`'s 'xla2'
    in bf16)."""
    L = packed["lin_b"].shape[0]
    keys = sorted(packed)
    for l in range(L):
        w = layer_weights(packed, l)
        if remat and not use_kernels and torch.is_grad_enabled():
            from torch.utils.checkpoint import checkpoint

            def run(h_, x_, hb_, e_w, pn, *ws):
                t = dict(tables, e_w=e_w, phore_norm=pn)
                return _layer(dict(zip(keys, ws)), h_, x_, hb_, t, dims,
                              False, False, False, block_dtype)
            h, x, hb = checkpoint(run, h, x, hb, tables["e_w"],
                                  tables["phore_norm"],
                                  *[w[k] for k in keys], use_reentrant=False)
        else:
            h, x, hb = _layer(w, h, x, hb, tables, dims, use_kernels,
                              merge_node_pre, merge_pos, block_dtype)
    return h, x, hb


# --------------------------------------------------------------------------
# the trainable fused stack: kernels forward, plain stages backward
# --------------------------------------------------------------------------

_DIFF_TABLES = ("e_w", "phore_norm")

# layer recomputes of `LayerStackFn.backward`: run as a replay of a captured
# CUDA graph, or eagerly (CPU tensors); graphs captured. Host-only counts.
STACK_GRAPH = {"captures": 0, "replays": 0, "eager": 0}


def reset_stack_graph_counts() -> None:
    for k in STACK_GRAPH:
        STACK_GRAPH[k] = 0


def _layer_grads(keys, d: StackDims, w, h, x, hb, t, cot):
    """One layer recomputed through the plain stages under autograd and
    pulled back from the cotangents `cot` of its outputs (h, x, hb): the
    gradients (h, x, hb, *`_DIFF_TABLES`, *w), None where one is unused.
    `w` is the layer's packed weights in the order of `keys`."""
    h, x, hb = (a.detach().requires_grad_(True) for a in (h, x, hb))
    w = [v.detach().requires_grad_(True) for v in w]
    tabs = [t[k].detach().requires_grad_(True) for k in _DIFF_TABLES]
    with torch.enable_grad():
        tl = dict(t, **dict(zip(_DIFF_TABLES, tabs)))
        outs = _layer(dict(zip(keys, w)), h, x, hb, tl, d, False, False,
                      False)
        return torch.autograd.grad(outs, [h, x, hb] + tabs + w, cot,
                                   allow_unused=True)


def _graphable(t: torch.Tensor) -> bool:
    """Whether the recompute runs as a captured graph: on CUDA tensors."""
    return t.is_cuda


def _capture(fn, pool=None):
    """`fn`'s launches captured as one CUDA graph after one warm-up on a
    side stream, in the memory pool `pool` (another graph's `pool()`;
    None: a new one). Returns (the graph, fn's outputs, which each replay
    rewrites)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool):
        outs = fn()
    return graph, outs


class _LayerGraph:
    """`_layer_grads` captured once over static copies of its inputs and
    replayed once a layer: each call copies the layer's weights, boundary
    and cotangents into the static inputs (every value changes from step
    to step), replays, and returns the static outputs, valid until the
    next replay. The tables are copied in once a backward (`load_tables`).
    `pool` is the memory pool the graph shares (`_capture`)."""

    def __init__(self, keys, d: StackDims, w, bound, t, cot, pool):
        static = lambda a: a.detach().clone()
        self.ins = [static(a) for a in (*w, *bound, *cot)]
        self.t = {k: static(v) for k, v in t.items()}
        n = len(w)
        self.graph, self.outs = _capture(lambda: _layer_grads(
            keys, d, self.ins[:n], *self.ins[n:n + 3], self.t,
            self.ins[n + 3:]), pool)
        STACK_GRAPH["captures"] += 1

    def load_tables(self, t):
        for k, v in self.t.items():
            v.copy_(t[k])

    def __call__(self, w, bound, cot):
        torch._foreach_copy_(self.ins, [*w, *bound, *cot])
        self.graph.replay()
        STACK_GRAPH["replays"] += 1
        return self.outs


# the captured layers by shape key; they and their shared memory pool are
# held until the process exits, and each new key's capture may grow the pool
_GRAPHS: Dict[tuple, _LayerGraph] = {}


def _layer_graph(keys, d: StackDims, values, bound, t, cot) -> _LayerGraph:
    """The captured layer for these shapes (captured at the first call of
    a key, from its last layer's inputs), its tables loaded. All layer
    graphs share one memory pool: they never replay at once, and each
    replay's outputs are copied out before the next."""
    sig = lambda a: (tuple(a.shape), a.dtype)
    key = (d, keys, values[0].device,
           tuple((tuple(v.shape[1:]), v.dtype) for v in values),
           tuple(sig(a) for a in bound),
           tuple((k, *sig(t[k])) for k in sorted(t)))
    graph = _GRAPHS.get(key)
    if graph is None:
        pool = next(iter(_GRAPHS.values())).graph.pool() if _GRAPHS \
            else None
        graph = _LayerGraph(keys, d, [v[-1] for v in values], bound, t, cot,
                            pool)
        _GRAPHS[key] = graph
    graph.load_tables(t)
    return graph


def _apply_pairs(op, dst, src):
    """op(dst, src) over the pairs whose source is not None (a gradient
    `allow_unused` left out)."""
    pairs = [(a, g) for a, g in zip(dst, src) if g is not None]
    if pairs:
        op(*map(list, zip(*pairs)))


class LayerStackFn(torch.autograd.Function):
    """`layer_stack` through its kernels with a backward.

    forward runs the stages (kernels on CUDA tensors) and saves only the
    layer-boundary (h, x, hb); backward walks the layers in reverse,
    recomputes ONE layer through the plain stages under autograd and pulls
    the cotangents back to that layer's packed weights, to h, x, hb and to
    the differentiable tables `e_w` and `phore_norm` (`_layer_grads`).
    Index and mask tables get no gradient (the kNN sets are frozen per
    block). There is no backward kernel, as in the JAX package, whose
    custom VJP recomputes `layer_stack_xla`; one layer at a time keeps the
    recomputed [B,NL,NL,K8,Wt] and per-head intermediates of a single
    layer live instead of the whole stack's. On CUDA tensors the recompute
    is one CUDA graph (`_LayerGraph`), captured at the first backward of
    its shapes and replayed once a layer, so the host enqueues a few
    copies and a replay where it would launch the recompute and its
    backward op by op; on the CPU the same function runs eagerly
    (`STACK_GRAPH` counts both). With bf16 inter-stage blocks
    (`block_dtype`, `fused_block_dtype`) the forward rounds pre_t and q_z to
    bf16 while the backward is that of the float32 stack on the same
    inputs: it first remakes the float32 layer boundaries (kernels with
    float32 blocks, no grad), then recomputes layer by layer as above. The
    rounding is passed straight through, as the JAX package's custom VJP
    does (its backward recomputes `layer_stack_xla` from the inputs, with
    no block dtype).

    Arguments: (dims, merge_node_pre, merge_pos, block_dtype, tables, keys,
    h, x, hb, e_w, phore_norm, *packed values in the order of `keys`)."""

    @staticmethod
    def forward(ctx, dims, merge_node_pre, merge_pos, block_dtype, tables,
                keys, h, x, hb, e_w, phore_norm, *values):
        packed = dict(zip(keys, values))
        t = dict(tables, e_w=e_w, phore_norm=phore_norm)
        L = packed["lin_b"].shape[0]
        bounds = []
        for l in range(L):
            bounds.append((h, x, hb))
            h, x, hb = _layer(layer_weights(packed, l), h, x, hb, t, dims,
                              True, merge_node_pre, merge_pos, block_dtype)
        ctx.dims, ctx.tables, ctx.keys = dims, t, keys
        ctx.bounds, ctx.values = bounds, values
        ctx.merges = (merge_node_pre, merge_pos)
        ctx.block_dtype = block_dtype
        return h, x, hb

    @staticmethod
    def backward(ctx, g_h, g_x, g_hb):
        with record_function("stack.backward"):
            dims, t, keys = ctx.dims, ctx.tables, ctx.keys
            L = len(ctx.bounds)
            if ctx.block_dtype != torch.float32:
                # straight through the block rounding: the layer boundaries
                # the backward starts from are those of the float32 stack on
                # the same inputs, not those of the rounded forward
                packed = dict(zip(keys, ctx.values))
                h, x, hb = ctx.bounds[0]
                with torch.no_grad():
                    for l in range(1, L):
                        h, x, hb = _layer(layer_weights(packed, l - 1), h, x,
                                          hb, t, dims, True, *ctx.merges)
                        ctx.bounds[l] = (h, x, hb)
            g_vals = [torch.zeros_like(v) for v in ctx.values]
            g_tab = [torch.zeros_like(t[k]) for k in _DIFF_TABLES]
            cot = (g_h, g_x, g_hb)
            graph = _layer_graph(keys, dims, ctx.values, ctx.bounds[-1], t,
                                 cot) if _graphable(g_hb) else None
            n = 3 + len(_DIFF_TABLES)
            for l in reversed(range(L)):
                w = [v[l] for v in ctx.values]
                if graph is None:
                    grads = _layer_grads(keys, dims, w, *ctx.bounds[l], t,
                                         cot)
                    STACK_GRAPH["eager"] += 1
                else:
                    grads = graph(w, ctx.bounds[l], cot)
                # order of `_layer`'s outputs and of its inputs is (h, x, hb)
                cot = tuple(torch.zeros_like(a) if g is None else g
                            for g, a in zip(grads[:3], ctx.bounds[l]))
                _apply_pairs(torch._foreach_add_, g_tab, grads[3:n])
                _apply_pairs(torch._foreach_copy_, [a[l] for a in g_vals],
                             grads[n:])
            if graph is not None:
                # the graph's outputs are rewritten by its next replay
                cot = tuple(g.clone() for g in cot)
            ctx.bounds = None
            return (None, None, None, None, None, None, *cot, *g_tab,
                    *g_vals)


def make_layer_stack_grad(dims: StackDims, merge_node_pre: bool = False,
                          merge_pos: bool = False, block_dtype=torch.float32):
    """The fused stack usable under autograd: f(packed, h, x, hb, tables)
    -> (h, x, hb), kernels forward, `LayerStackFn`'s backward (float32,
    straight through bf16 blocks). Without grad mode (sampling) it is
    `layer_stack` itself."""
    def f(packed, h, x, hb, tables):
        if not torch.is_grad_enabled():
            return layer_stack(packed, h, x, hb, tables, dims, True,
                               merge_node_pre, merge_pos,
                               block_dtype=block_dtype)
        keys = tuple(sorted(packed))
        return LayerStackFn.apply(
            dims, merge_node_pre, merge_pos, block_dtype, tables, keys, h, x,
            hb, tables["e_w"], tables["phore_norm"],
            *[packed[k] for k in keys])
    return f


# --------------------------------------------------------------------------
# the one entry: which driver runs each `fused_stack` value
# --------------------------------------------------------------------------

# fused_stack value -> (merge_node_pre, merge_pos) of the kernel path, or
# None: the plain stages
FUSED_STACKS = {"pallas": (False, False), "pallas3": (True, False),
                "pallas2": (True, True), "xla": None, "xla2": None}


def run_stack(mode: str, packed: Dict[str, torch.Tensor], h, x, hb,
              tables: Dict[str, torch.Tensor], dims: StackDims,
              block_dtype=torch.float32, remat: bool = False):
    """The fused stack of `fused_stack` value `mode` (a key of
    `FUSED_STACKS`) on float32 carries; h, x and hb come back in the
    dtypes they came in. 'pallas*' run `make_layer_stack_grad` with
    `block_dtype` as the inter-stage blocks' type; 'xla' and 'xla2' run the
    plain stages (`layer_stack(use_kernels=False)`, `remat` recomputing
    each layer in the backward). 'xla2' with a `block_dtype` other than
    float32 is the JAX package's `layer_stack_xla2(dtype=)`: the carries h
    and hb and the packed weights are cast to it once (differentiably), and
    the stages compute in it; 'xla' ignores `block_dtype`."""
    merges = FUSED_STACKS[mode]
    hc, xc, hbc = (a.float().contiguous() for a in (h, x, hb))
    if merges is not None:
        out = make_layer_stack_grad(dims, *merges, block_dtype=block_dtype)(
            packed, hc, xc, hbc, tables)
    else:
        if mode == "xla2" and block_dtype != torch.float32:
            packed = {k: v.to(block_dtype) for k, v in packed.items()}
            hc, hbc = hc.to(block_dtype), hbc.to(block_dtype)
        out = layer_stack(packed, hc, xc, hbc, tables, dims,
                          use_kernels=False, remat=remat)
    return out[0].to(h.dtype), out[1].to(x.dtype), out[2].to(hb.dtype)
