"""Fused whole-layer-stack execution of the denoiser: four stages per layer.

Counterpart of `phoregen_tpu/ops/layer_stack.py::layer_stack_pallas`. Each
attention layer runs four stages, each a hand-written CUDA kernel on the
card (`csrc/layer_stack.cu`) with a plain PyTorch version beside it:

    stage_node         <- _stage_pallas o _stage_node         (A: new h)
    stage_triplet_pre  <- _stage_pallas o _stage_triplet_pre  (B1: pre_t, q_z)
    stage_triplet_att  <- _att_pallas / _head_att_accumulate  (B2: new hb)
    stage_pos          <- _stage_pallas o _stage_pos          (C: new x)

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. `LAUNCHES` counts kernel
launches per stage.

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

from .knn import knn_neighbors
from .rbf import (angular_encoding, angular_encoding_freq_bands,
                  gaussian_smearing, gaussian_smearing_offsets)

LN_EPS = 1e-6
NEG_INF = -1e9
CROSS_SQ_EPS = 1e-12

LAUNCHES = {"stage_node": 0, "stage_triplet_pre": 0, "stage_triplet_att": 0,
            "stage_pos": 0}


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
    `nodeC_W`: every projection of one node-feature tensor in one matrix)."""
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


def _rbf(dist):
    return gaussian_smearing(dist, *gaussian_smearing_offsets(fix_offset=True))


def _qmlp(z, s, b, W1, b1):
    return torch.relu(_ln(z, s, b)) @ W1 + b1


def _knn_edge_prefeat(w, x, t, d: StackDims, lo: int, hi: int):
    """First-layer pre-activations (columns [lo, hi) of e_W) of the kNN
    edge MLPs and the relative vectors rel = x[dst] - x[src] (masked
    sources read as 0, as the TPU's masked one-hot gather does)."""
    NP = d.NP
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
    dire9 = dire3 @ w["dire_W"] + w["dire_b"]
    et = t["edge_type"]                                       # [B,N,K,4]
    trbf = (et[..., :, None] * rbf[..., None, :]).flatten(-2)  # [B,N,K,80]
    feat = torch.cat([trbf, et, dire9], -1)                   # [B,N,K,93]
    return feat @ w["e_W"][:, lo:hi] + w["e_b"][lo:hi], rel


def stage_node_plain(w, h, x, hb, t, d: StackDims):
    """Stage A: kNN-edge and bond-grid node attention -> new_h [B,N,H]."""
    B, N, H = h.shape
    NP, NL, K, nh = d.NP, d.NL, d.K, d.heads
    dh = H // nh
    e_pre, _ = _knn_edge_prefeat(w, x, t, d, 0, 2 * H)
    nproj = h @ w["e_Wn_h"]                                   # [B,N,4H]
    pre = (e_pre + _gather_rows(nproj[..., 2 * H:], t["nbr_idx"])
           * t["nbr_mask"][..., None] + nproj[:, :, None, :2 * H])
    k = torch.relu(_ln(pre[..., :H], w["e_ln_s"][0], w["e_ln_b"][0]))
    v = torch.relu(_ln(pre[..., H:], w["e_ln_s"][1], w["e_ln_b"][1]))
    k = k @ w["e_k2"][0] + w["e_b2"][0]
    v = (v @ w["e_k2"][1] + w["e_b2"][1]) * t["e_w"][..., None]
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
    out_b = torch.cat([torch.zeros_like(h[:, :NP]), out_b], 1)
    return h + ((out_e + out_b) @ w["lin_W"] + w["lin_b"])


def _pair_mask(t):
    ml = t["mask_l"]
    NL = ml.shape[1]
    eye = torch.eye(NL, dtype=ml.dtype, device=ml.device)
    return ml[:, :, None] * ml[:, None, :] * (1.0 - eye)


def stage_triplet_pre_plain(w, h, x, hb, t, d: StackDims):
    """Stage B1: head-independent triplet features.
    Returns (pre_t [B,j,i,K8,Wt], q_z [B,j,i,H])."""
    NP, Wt = d.NP, d.Wt
    pos_l, h_l = x[:, NP:], h[:, NP:]
    rel_l = pos_l[:, :, None, :] - pos_l[:, None, :, :]     # [B,x,i]=x-i
    r_feat = _rbf(torch.sqrt((rel_l * rel_l).sum(-1) + 1e-12))
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
    enc = angular_encoding(torch.atan2(cross, dot),
                           angular_encoding_freq_bands(d.num_ang))
    pre = a_kj_sel[:, :, None] + a_ji[:, :, :, None] + enc @ w["t_Wang"]
    return torch.relu(_ln(pre, w["t_ln_s"], w["t_ln_b"])), q_z


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
    -> hb + triplet update [B,NL,NL,H]."""
    q = torch.einsum("bjic,hcw->bjihw", q_z, w["tq_W1"]) + w["tq_b1"]
    sc = torch.einsum("bjikw,bjihw->bjikh", pre_t, q) * (
        1.0 / float(np.sqrt(d.Wt)))
    al = _softmax_masked(sc, trip_valid(t)[..., None], 3)
    pooled = torch.einsum("bjikh,bjikw->bjihw", al, pre_t)
    return hb + (torch.einsum("bjihw,hwc->bjic", pooled, w["t_out_W"])
                 + w["t_out_b"])


def stage_pos_plain(w, new_h, x, hb_new, t, d: StackDims):
    """Stage C: kNN-edge and bond-grid position updates -> x_new [B,N,3]."""
    B, N, H = new_h.shape
    NP, NL, K, nh = d.NP, d.NL, d.K, d.heads
    dh = H // nh
    e_pre, rel = _knn_edge_prefeat(w, x, t, d, 2 * H, 4 * H)
    nproj = new_h @ w["e_Wn_nh"]
    pre = (e_pre + _gather_rows(nproj[..., 2 * H:], t["nbr_idx"])
           * t["nbr_mask"][..., None] + nproj[:, :, None, :2 * H])
    xk = torch.relu(_ln(pre[..., :H], w["e_ln_s"][2], w["e_ln_b"][2]))
    xv = torch.relu(_ln(pre[..., H:], w["e_ln_s"][3], w["e_ln_b"][3]))
    xk = xk @ w["e_xk2"] + w["e_xk2b"]
    xv = (xv @ w["e_xv2"] + w["e_xv2b"]) * t["e_w"][..., None]
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


def _ptr(tensor, name, dtype=torch.float32):
    if not tensor.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if tensor.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return tensor.data_ptr()


def _launch(entry: str, named, d: StackDims, B: int):
    from . import _build
    lib = _build.load()
    ptrs = []
    for name, ten in named:
        dt = torch.int32 if name in ("nbr_idx", "lig3_idx", "trip_idx") \
            else torch.float32
        ptrs.append(_ptr(ten, name, dt))
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    dims = (ctypes.c_int * 8)(B, d.NP, d.NL, d.K, d.K8, d.H, d.heads, d.Wt)
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, entry)(arr, len(ptrs), dims, stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def _check_shapes(d: StackDims, B: int, t, **named):
    """The kernels index by `d`; a tensor of another shape would be read
    out of bounds, so raise before launching."""
    want = {"h": (B, d.N, d.H), "x": (B, d.N, 3),
            "hb": (B, d.NL, d.NL, d.H), "pre_t": (B, d.NL, d.NL, d.K8, d.Wt),
            "q_z": (B, d.NL, d.NL, d.H), "nbr_idx": (B, d.N, d.K),
            "trip_idx": (B, d.NL, d.K8)}
    named.update((k, t[k]) for k in ("nbr_idx", "trip_idx"))
    for name, ten in named.items():
        if tuple(ten.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(ten.shape)}, expected "
                             f"{want[name]} for {d}")


def stage_node(w, h, x, hb, t, d: StackDims):
    """Stage A; CUDA kernel for CUDA tensors, plain version on the CPU."""
    if not h.is_cuda:
        return stage_node_plain(w, h, x, hb, t, d)
    B = h.shape[0]
    _check_shapes(d, B, t, h=h, x=x, hb=hb)
    out = torch.empty_like(h)
    P = torch.empty(B * d.N, 10 * d.H, device=h.device, dtype=torch.float32)
    named = ([("h", h), ("x", x), ("hb", hb), ("out", out), ("P", P)]
             + [(k, t[k]) for k in _TABLE_ARGS] + [(k, w[k]) for k in _NODE_W])
    _launch("ls_stage_node", named, d, B)
    LAUNCHES["stage_node"] += 1
    return out


def stage_triplet_pre(w, h, x, hb, t, d: StackDims):
    """Stage B1; CUDA kernel for CUDA tensors, plain version on the CPU."""
    if not h.is_cuda:
        return stage_triplet_pre_plain(w, h, x, hb, t, d)
    B = h.shape[0]
    _check_shapes(d, B, t, h=h, x=x, hb=hb)
    pre_t = torch.empty(B, d.NL, d.NL, d.K8, d.Wt, device=h.device)
    q_z = torch.empty(B, d.NL, d.NL, d.H, device=h.device)
    PB = torch.empty(B * d.NL, 2 * d.Wt + d.H, device=h.device)
    named = ([("h", h), ("x", x), ("hb", hb), ("pre_t", pre_t), ("q_z", q_z),
              ("PB", PB), ("trip_idx", t["trip_idx"])]
             + [(k, w[k]) for k in _TRIP_PRE_W])
    _launch("ls_stage_trip_pre", named, d, B)
    LAUNCHES["stage_triplet_pre"] += 1
    return pre_t, q_z


def stage_triplet_att(w, hb, pre_t, q_z, t, d: StackDims):
    """Stage B2; CUDA kernel for CUDA tensors, plain version on the CPU."""
    if not hb.is_cuda:
        return stage_triplet_att_plain(w, hb, pre_t, q_z, t, d)
    B = hb.shape[0]
    _check_shapes(d, B, t, hb=hb, pre_t=pre_t, q_z=q_z)
    out = torch.empty_like(hb)
    named = ([("hb", hb), ("pre_t", pre_t), ("q_z", q_z), ("out", out),
              ("trip_idx", t["trip_idx"]), ("trip_mask", t["trip_mask"]),
              ("mask_l", t["mask_l"])] + [(k, w[k]) for k in _TRIP_ATT_W])
    _launch("ls_stage_trip_att", named, d, B)
    LAUNCHES["stage_triplet_att"] += 1
    return out


def stage_pos(w, new_h, x, hb_new, t, d: StackDims):
    """Stage C; CUDA kernel for CUDA tensors, plain version on the CPU."""
    if not new_h.is_cuda:
        return stage_pos_plain(w, new_h, x, hb_new, t, d)
    B = new_h.shape[0]
    _check_shapes(d, B, t, h=new_h, x=x, hb=hb_new)
    out = torch.empty_like(x)
    P = torch.empty(B * d.N, 10 * d.H, device=x.device, dtype=torch.float32)
    named = ([("new_h", new_h), ("x", x), ("hb", hb_new), ("out", out),
              ("P", P)] + [(k, t[k]) for k in _TABLE_ARGS]
             + [(k, w[k]) for k in _POS_W])
    _launch("ls_stage_pos", named, d, B)
    LAUNCHES["stage_pos"] += 1
    return out


def layer_weights(packed: Dict[str, torch.Tensor], l: int):
    return {k: v[l] for k, v in packed.items()}


def layer_stack(packed: Dict[str, torch.Tensor], h, x, hb,
                tables: Dict[str, torch.Tensor], dims: StackDims):
    """h [B,N,H]; x [B,N,3]; hb [B,NL,NL,H]; tables from
    `build_block_tables` plus 'edge_type' [B,N,K,4], 'e_w' [B,N,K] and
    'phore_norm' [B,NP,3]. Runs the four stages layer by layer, as
    `layer_stack_pallas` does."""
    L = packed["lin_b"].shape[0]
    for l in range(L):
        w = layer_weights(packed, l)
        new_h = stage_node(w, h, x, hb, tables, dims)
        pre_t, q_z = stage_triplet_pre(w, h, x, hb, tables, dims)
        hb = stage_triplet_att(w, hb, pre_t, q_z, tables, dims)
        x = stage_pos(w, new_h, x, hb, tables, dims)
        h = new_h
    return h, x, hb
