"""The graph-attention denoiser, fused-stack path.

Counterpart of `phoregen_tpu/models/denoiser.py::UniDenoiser` with
`fused_stack='pallas'`: per block, rebuild the kNN graph over the current
positions, derive the 4-way ll/lp/pl/pp edge type and the sigmoid global
edge weight from `edge_pred_layer`, build the block's index tables (the
layer-internal kNN sets are frozen per block, their values use current
positions), then run the whole layer stack through `ops/layer_stack.py`
(four hand-written kernels per layer on the card).

Layout: composed node axis = [phore(NP); ligand(NL)].
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..ops import layer_stack as ls
from ..ops.knn import knn_neighbors
from ..ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from .layers import MLP, ParamTree

# fused_stack values that run the four-stage kernel path; the others are
# later slices of the port (ROADMAP.md, "Still to port")
FUSED_STACKS = ("pallas",)
_LATER = {
    "none": "the per-layer module path (fused_stack 'none')",
    "xla": "the per-layer module path (fused_stack 'none'); use 'pallas'",
    "xla2": "the per-layer module path (fused_stack 'none'); use 'pallas'",
    "pallas3": "kernel 5, the merged node+triplet-pre stage (pallas3)",
    "pallas2": "kernel 6, triplet attention with the pos epilogue (pallas2)",
}


def layer_param_shapes(H: int, heads: int, Wt: int, fe: int, L: int,
                       num_ang: int = 3) -> Dict:
    """Shapes of the stacked per-layer params (flax tree under
    `denoiser.layers.layer`, every leaf leading with L)."""
    def dense(i, o):
        return {"kernel": (L, i, o), "bias": (L, o)}

    def mlp(i, o):
        return {"Dense_0": dense(i, H), "LayerNorm_0": {"scale": (L, H),
                                                        "bias": (L, H)},
                "Dense_1": dense(H, o)}

    enc = 1 + 4 * num_ang
    return {
        "bond_layer": {
            "tf_ang_w": (L, enc, Wt), "tf_ji": {"kernel": (L, 20, Wt)},
            "tf_kj": dense(3 * H + 20, Wt), "tf_ln_bias": (L, Wt),
            "tf_ln_scale": (L, Wt), "tf_out": dense(heads * Wt, H),
            "tf_q": mlp(2 * H, heads * Wt)},
        "dire_embedding": dense(3, 9),
        "lin_node": dense(H, H),
        "node_layer_with_bond": {"hk": mlp(3 * H, H), "hv": mlp(3 * H, H),
                                 "hq": mlp(H, H)},
        "node_layer_with_edge": {"hk": mlp(fe + 2 * H, H),
                                 "hv": mlp(fe + 2 * H, H), "hq": mlp(H, H)},
        "pos_layer_with_bond": {"xk": mlp(3 * H, H), "xv": mlp(3 * H, heads),
                                "xq": mlp(H, H)},
        "pos_layer_with_edge": {"xk": mlp(fe + 2 * H, H),
                                "xv": mlp(fe + 2 * H, heads),
                                "xq": mlp(H, H)},
    }


class UniDenoiser(nn.Module):
    """num_blocks x (graph rebuild -> fused layer stack)."""

    def __init__(self, dcfg):
        super().__init__()
        self.cfg = dcfg
        self.fused_stack = dcfg.fused_stack
        if self.fused_stack not in FUSED_STACKS:
            raise NotImplementedError(
                f"denoiser.fused_stack={self.fused_stack!r} is not ported "
                f"yet: ROADMAP.md lists it under 'Still to port' as "
                f"{_LATER.get(self.fused_stack, 'an unknown value')}. The "
                f"PyTorch port runs fused_stack='pallas'.")
        if dcfg.fused_block_dtype != "float32":
            raise NotImplementedError(
                "fused_block_dtype='bfloat16' is not ported yet (ROADMAP.md, "
                "'Still to port': bf16 blocks)")
        required = dict(scan_layers=dcfg.scan_layers, norm=dcfg.norm,
                        direction_match=dcfg.direction_match,
                        include_h_node=dcfg.h_node_in_bond_net,
                        factorized=dcfg.triplet_mode == "factorized",
                        triplet_knn=dcfg.triplet_knn > 0,
                        no_x2h_out_fc=not dcfg.x2h_out_fc,
                        use_global_ew=dcfg.use_global_ew,
                        num_r_gaussian_20=dcfg.num_r_gaussian == 20,
                        edge_feat_dim_4=dcfg.edge_feat_dim == 4,
                        cutoff_knn=dcfg.cutoff_mode == "knn",
                        act_relu=dcfg.act_fn == "relu")
        missing = [k for k, v in required.items() if not v]
        if missing:
            raise ValueError(
                f"denoiser.fused_stack={self.fused_stack!r} requires the "
                f"flagship configuration; unmet: {missing}")
        H = dcfg.hidden_dim
        self.fe = dcfg.num_r_gaussian * dcfg.edge_feat_dim \
            + dcfg.edge_feat_dim + 9
        self.edge_pred_layer = MLP(dcfg.num_r_gaussian, 1, H, dcfg.norm)
        self.layers = ParamTree({"layer": layer_param_shapes(
            H, dcfg.n_heads, dcfg.triplet_width, self.fe, dcfg.num_layers)})

    def pack_fused(self) -> Dict[str, torch.Tensor]:
        """Packed per-layer weights; loop-invariant through a reverse
        process, so the sampler packs once and passes them to forward."""
        return ls.pack_layer_params(self.layers.layer.tree(),
                                    self.cfg.hidden_dim, self.fe)

    def forward(self, h, x, h_bond, node_mask, phore_norm, num_phore: int,
                packed=None):
        """h [B,N,H]; x [B,N,3]; h_bond [B,NL,NL,H]; node_mask [B,N];
        phore_norm [B,NP,3]. Returns (h, x, h_bond)."""
        dcfg = self.cfg
        B, N, H = h.shape
        NP = num_phore
        NL = N - NP
        if packed is None:
            packed = self.pack_fused()
        offsets, coeff = gaussian_smearing_offsets(fix_offset=True)
        is_lig = torch.cat([torch.zeros(NP, dtype=torch.long),
                            torch.ones(NL, dtype=torch.long)]).to(h.device)
        dims = ls.StackDims(NP=NP, NL=NL, K=min(dcfg.knn, N - 1),
                            K8=min(dcfg.triplet_knn, NL - 1), H=H,
                            heads=dcfg.n_heads, Wt=dcfg.triplet_width)
        for _ in range(dcfg.num_blocks):
            nbr_idx, nbr_mask = knn_neighbors(x, node_mask, dcfg.knn)
            # 4-way edge type: (src_lig,dst_lig)->0, (1,0)->1, (0,1)->2, (0,0)->3
            src_lig = is_lig[nbr_idx]
            dst_lig = is_lig[None, :, None].expand_as(src_lig)
            etype = 3 - 2 * src_lig - dst_lig
            edge_type = nn.functional.one_hot(etype, 4).to(torch.float32)
            xj = torch.gather(x, 1, nbr_idx.reshape(B, -1, 1).expand(-1, -1, 3)
                              ).reshape(B, N, -1, 3)
            diff = x[:, :, None, :] - xj
            dist = torch.sqrt((diff * diff).sum(-1) + 1e-12)
            e_w = torch.sigmoid(self.edge_pred_layer(
                gaussian_smearing(dist, offsets, coeff))[..., 0])
            tables = ls.build_block_tables(x, node_mask, nbr_idx, nbr_mask,
                                           NP, dcfg.triplet_knn)
            tables["edge_type"] = edge_type.contiguous()
            tables["e_w"] = e_w.to(torch.float32).contiguous()
            tables["phore_norm"] = phore_norm.to(torch.float32).contiguous()
            h, x, h_bond = ls.layer_stack(
                packed, h.contiguous(), x.contiguous(),
                h_bond.contiguous(), tables, dims)
        return h, x, h_bond
