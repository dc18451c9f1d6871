"""The graph-attention denoiser over the composed phore+ligand point cloud.

Counterpart of `phoregen_tpu/models/denoiser.py::UniDenoiser`: per block,
rebuild the neighbour graph over the current positions (`cutoff_mode` knn,
radius or hybrid), derive the 4-way ll/lp/pl/pp edge type and the sigmoid
global edge weight from `edge_pred_layer`, then run the shared stack of
attention layers. `fused_stack` selects how the stack runs:

- 'none': the per-layer module path (`_attention_layer`): two node
  updates, the triplet bond update, two position updates masked to ligand
  atoms, each layer rebuilding its own kNN sets unless `block_knn_freeze`.
  With all-k triplets (`triplet_knn` 0 or >= NL-1) and
  `use_pallas_triplet`, the triplet pool is the CUDA kernel of
  `ops/pallas_triplet.py`. `remat_layers` recomputes each layer in the
  backward (`torch.utils.checkpoint`).
- 'pallas': the fused layer stack of `ops/layer_stack.py` (four CUDA
  kernels per layer on the card), kNN sets frozen per block.
- 'pallas3': the same with stages A and B1 merged into one kernel (three
  per layer); 'pallas2': B2 and C merged as well (two per layer).
- 'xla', 'xla2': the same fused stack through its plain PyTorch stages on
  any device (the JAX package's packed-XLA forms of the same math).
`ops/layer_stack.run_stack` runs every fused value and alone decides
how (its table `FUSED_STACKS`): 'pallas*' through `make_layer_stack_grad`
(kernels forward, plain stages recomputed layer by layer backward), so the
fused stack trains; 'xla'/'xla2' differentiated by autograd, layer by
layer with `remat_layers`. The stack runs on float32 carries (h and the
bond grid are cast at its entry and back at its exit).
`fused_block_dtype` 'bfloat16' means, as in the JAX package: on
'pallas*' the inter-stage blocks pre_t and q_z are stored in bf16 between
the kernels, all arithmetic float32, and the backward passes straight
through the rounding; on 'xla2' the h / bond-grid carries and the packed
weights are bf16 and the plain stages compute in them; 'xla' ignores it.

Mixed precision (`compute_dtype`): the layers follow the dtype of h and of
the parameters they are given (see models/layers.py); positions and the
geometry stay float32.

Layout: composed node axis = [phore(NP); ligand(NL)].
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..constants import FIXED_RBF_OFFSETS
from ..ops import layer_stack as ls
from ..ops.knn import hybrid_neighbors, knn_neighbors, radius_neighbors
from ..ops.masked import masked_mean
from ..ops.rbf import gaussian_smearing, gaussian_smearing_offsets
from .layers import (MLP, BondUpdateTriplet, NodeUpdateDense, NodeUpdateKNN,
                     ParamTree, PosUpdateDense, PosUpdateKNN, dense_shapes,
                     dtype_of, gather_nodes)

def layer_param_shapes(H: int, heads: int, Wt: int, fe: int,
                       L: Optional[int] = None, num_ang: int = 3, *,
                       norm: bool = True, out_fc: bool = False,
                       include_h_node: bool = True,
                       direction_match: bool = True,
                       triplet_mode: str = "factorized") -> Dict:
    """Shapes of one attention layer's flax parameter tree; with `L` every
    leaf leads with the layer axis (the `scan_layers` tree under
    `denoiser.layers.layer`)."""
    spec = {
        "bond_layer": BondUpdateTriplet.shapes(
            H, heads, norm, include_h_node, num_ang, triplet_mode, Wt),
        "dire_embedding": dense_shapes(3, 9),
        "lin_node": dense_shapes(H, H),
        "node_layer_with_bond": NodeUpdateDense.shapes(H, H, norm, out_fc),
        "node_layer_with_edge": NodeUpdateKNN.shapes(fe, H, norm, out_fc),
        "pos_layer_with_bond": PosUpdateDense.shapes(H, H, heads, norm),
        "pos_layer_with_edge": PosUpdateKNN.shapes(fe, H, heads, norm),
    }
    if not direction_match:
        del spec["dire_embedding"]

    def stack(t):
        return {k: stack(v) if isinstance(v, dict) else (L, *v)
                for k, v in t.items()}
    return spec if L is None else stack(spec)


def neighbor_centroid_norm(pos_l, mask_l, k: int = 3, frozen=None):
    """Mean of the k nearest ligand neighbours minus own position; `frozen`
    is an optional (idx, mask) table fixed once per block."""
    nbr_idx, nbr_mask = frozen if frozen is not None \
        else knn_neighbors(pos_l, mask_l, k)
    xj = gather_nodes(pos_l, nbr_idx)                         # [B,NL,k,3]
    return masked_mean(xj, nbr_mask[..., None], dim=2) - pos_l


def _unstack(tree, L: int):
    """Stacked tree (every leaf [L, ...]) -> list of L per-layer trees."""
    out = [{} for _ in range(L)]
    for k, v in tree.items():
        parts = _unstack(v, L) if isinstance(v, dict) else torch.unbind(v, 0)
        for layer, part in zip(out, parts):
            layer[k] = part
    return out


def _cast_tree(tree, dtype: torch.dtype):
    """A parameter tree with every floating leaf in `dtype` (a
    differentiable copy; leaves already in it are kept)."""
    return {k: _cast_tree(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


class UniDenoiser(nn.Module):
    """num_blocks x (graph rebuild -> num_layers attention layers)."""

    def __init__(self, dcfg):
        super().__init__()
        self.cfg = dcfg
        self.fused_stack = dcfg.fused_stack
        if self.fused_stack != "none" \
                and self.fused_stack not in ls.FUSED_STACKS:
            raise ValueError(f"unknown fused_stack {self.fused_stack!r}")
        self.block_dtype = dtype_of(dcfg.fused_block_dtype,
                                    "fused_block_dtype")
        if dcfg.cutoff_mode not in ("knn", "radius", "hybrid"):
            raise NotImplementedError(
                f"cutoff_mode {dcfg.cutoff_mode!r} (supported: knn, radius, "
                f"hybrid)")
        if self.fused_stack != "none":
            self._check_fused_config()
        H, heads = dcfg.hidden_dim, dcfg.n_heads
        # the edge distances are smeared on the fixed grid whatever
        # num_r_gaussian says, as in the JAX package (whose layers take
        # their input widths from the features)
        n_rbf = len(FIXED_RBF_OFFSETS)
        self.fe = n_rbf * dcfg.edge_feat_dim \
            + dcfg.edge_feat_dim + (9 if dcfg.direction_match else 0)
        if dcfg.use_global_ew:
            # relu whatever act_fn says, as in the JAX package
            self.edge_pred_layer = MLP(n_rbf, 1, H, dcfg.norm)
        shapes = dict(norm=dcfg.norm, out_fc=dcfg.x2h_out_fc,
                      include_h_node=dcfg.h_node_in_bond_net,
                      direction_match=dcfg.direction_match,
                      triplet_mode=dcfg.triplet_mode)
        if dcfg.scan_layers:
            self.layers = ParamTree({"layer": layer_param_shapes(
                H, heads, dcfg.triplet_width, self.fe, dcfg.num_layers,
                **shapes)})
        else:
            for i in range(dcfg.num_layers):
                self.add_module(f"layer_{i}", ParamTree(layer_param_shapes(
                    H, heads, dcfg.triplet_width, self.fe, **shapes)))
        att = dict(hidden_dim=H, n_heads=heads, norm=dcfg.norm,
                   act_fn=dcfg.act_fn, apply_style=dcfg.edge_mlp_apply)
        self.node_knn = NodeUpdateKNN(out_fc=dcfg.x2h_out_fc, **att)
        self.node_bond = NodeUpdateDense(out_fc=dcfg.x2h_out_fc, **att)
        self.bond_update = BondUpdateTriplet(
            include_h_node=dcfg.h_node_in_bond_net, mode=dcfg.triplet_mode,
            width=dcfg.triplet_width, use_pallas=dcfg.use_pallas_triplet,
            knn_k=dcfg.triplet_knn,
            pool_follow_dtype=dcfg.triplet_pool_follow_dtype, **att)
        self.pos_knn = PosUpdateKNN(**att)
        self.pos_bond = PosUpdateDense(**att)

    def _check_fused_config(self):
        """The packed-weight layout is written for the flagship
        configuration (edge-feature split [4x20 RBF | 4 type | 9 dire],
        stacked layers, factorized kNN triplets); any cutoff_mode (the
        hybrid table is NL + knn wide, within the kernels' K <= H at the
        flagship's widths). The stages hard-code relu, as the JAX stack
        does; the JAX package runs its fused stack under another act_fn
        regardless (and so departs from its own module path), the port
        refuses it."""
        dcfg = self.cfg
        required = dict(scan_layers=dcfg.scan_layers, norm=dcfg.norm,
                        direction_match=dcfg.direction_match,
                        include_h_node=dcfg.h_node_in_bond_net,
                        factorized=dcfg.triplet_mode == "factorized",
                        triplet_knn=dcfg.triplet_knn > 0,
                        no_x2h_out_fc=not dcfg.x2h_out_fc,
                        use_global_ew=dcfg.use_global_ew,
                        num_r_gaussian_20=dcfg.num_r_gaussian == 20,
                        edge_feat_dim_4=dcfg.edge_feat_dim == 4,
                        act_relu=dcfg.act_fn == "relu")
        missing = [k for k, v in required.items() if not v]
        if missing:
            raise ValueError(
                f"denoiser.fused_stack={self.fused_stack!r} requires the "
                f"flagship configuration; unmet: {missing}")

    def pack_fused(self) -> Optional[Dict[str, torch.Tensor]]:
        """Packed per-layer weights of the fused stack, built with torch
        ops on the live parameters (so they carry gradients when grad mode
        is on). Loop-invariant through a reverse process, so the sampler
        packs once under `no_grad` and passes them to forward; training
        packs anew every step (forward does when `packed` is None). None
        when no fused stack is configured."""
        if self.fused_stack == "none":
            return None
        return ls.pack_layer_params(self.layers.layer.tree(),
                                    self.cfg.hidden_dim, self.fe)

    def layer_trees(self):
        """One parameter tree per attention layer, from either layout."""
        L = self.cfg.num_layers
        if self.cfg.scan_layers:
            return _unstack(self.layers.layer.tree(), L)
        return [getattr(self, f"layer_{i}").tree() for i in range(L)]

    def _neighbors(self, x, node_mask, NP):
        dcfg = self.cfg
        if dcfg.cutoff_mode == "knn":
            return knn_neighbors(x, node_mask, dcfg.knn)
        if dcfg.cutoff_mode == "radius":
            return radius_neighbors(x, node_mask, dcfg.knn, dcfg.r_max)
        return hybrid_neighbors(x, node_mask, NP, dcfg.knn)

    def forward(self, h, x, h_bond, node_mask, phore_norm, num_phore: int,
                packed=None):
        """h [B,N,H]; x [B,N,3]; h_bond [B,NL,NL,H] (src, dst);
        node_mask [B,N]; phore_norm [B,NP,3]; `packed`: optional
        `pack_fused()` output. Returns (h, x, h_bond)."""
        dcfg = self.cfg
        _, N, H = h.shape
        NP = num_phore
        NL = N - NP
        if dcfg.direction_match and phore_norm is None:
            raise ValueError(
                "direction_match=True requires phore_norm (got None)")
        fused = self.fused_stack != "none"
        if fused and packed is None:
            packed = self.pack_fused()
        layers = None if fused else self.layer_trees()
        if not fused and h_bond.dtype != h.dtype and dcfg.scan_layers:
            # the JAX package's nn.scan refuses this too: the first layer
            # promotes h to the float32 of the bond carry
            raise ValueError(
                f"the per-layer module path with scan_layers cannot carry "
                f"h in {h.dtype} beside a bond grid in {h_bond.dtype} (bf16 "
                "compute without bond_diffusion): the first layer promotes "
                "h; use a fused stack or scan_layers false")
        offsets, coeff = gaussian_smearing_offsets(fix_offset=True)
        is_lig = (torch.arange(N, device=h.device) >= NP).long()
        node_mask = node_mask.to(torch.bool)
        mask_l = node_mask[:, NP:]
        eye = torch.eye(NL, dtype=torch.bool, device=h.device)
        pair_mask = mask_l[:, :, None] & mask_l[:, None, :] & ~eye
        for _ in range(dcfg.num_blocks):
            nbr_idx, nbr_mask = self._neighbors(x, node_mask, NP)
            # 4-way edge type: (src_lig,dst_lig)->0, (1,0)->1, (0,1)->2, (0,0)->3
            src_lig = is_lig[nbr_idx]
            dst_lig = is_lig[None, :, None].expand_as(src_lig)
            etype = 3 - 2 * src_lig - dst_lig
            edge_type = nn.functional.one_hot(etype, 4).to(h.dtype)
            e_w = None
            if dcfg.use_global_ew:
                diff = x[:, :, None, :] - gather_nodes(x, nbr_idx)
                dist = torch.sqrt((diff * diff).sum(-1) + 1e-12)
                # position-derived features drop to the feature dtype
                e_w = torch.sigmoid(self.edge_pred_layer(
                    gaussian_smearing(dist, offsets, coeff).to(h.dtype)
                )[..., 0])
            if fused:
                tables = ls.build_block_tables(x, node_mask, nbr_idx,
                                               nbr_mask, NP, dcfg.triplet_knn)
                tables["edge_type"] = edge_type.to(torch.float32).contiguous()
                tables["e_w"] = e_w.to(torch.float32).contiguous()
                tables["phore_norm"] = phore_norm.to(
                    torch.float32).contiguous()
                dims = ls.StackDims(
                    NP=NP, NL=NL, K=nbr_idx.shape[-1],
                    K8=min(dcfg.triplet_knn, NL - 1), H=H,
                    heads=dcfg.n_heads, Wt=dcfg.triplet_width)
                h, x, h_bond = ls.run_stack(
                    self.fused_stack, packed, h, x, h_bond, tables, dims,
                    self.block_dtype, dcfg.remat_layers)
                continue
            lig3 = trip = None
            if dcfg.block_knn_freeze:
                pos_l0 = x[:, NP:]
                lig3 = knn_neighbors(pos_l0, mask_l, 3)
                if 0 < dcfg.triplet_knn < NL - 1:
                    trip = knn_neighbors(pos_l0, mask_l, dcfg.triplet_knn)
            for p in layers:
                layer_args = (p, h, x, edge_type, nbr_idx, nbr_mask, h_bond,
                              mask_l, pair_mask, e_w, phore_norm, NP, lig3,
                              trip)
                if dcfg.remat_layers and torch.is_grad_enabled():
                    from torch.utils.checkpoint import checkpoint
                    h, h_bond, x = checkpoint(self._attention_layer,
                                              *layer_args,
                                              use_reentrant=False)
                else:
                    h, h_bond, x = self._attention_layer(*layer_args)
        return h, x, h_bond

    def _attention_layer(self, p, h, x, edge_type, nbr_idx, nbr_mask, h_bond,
                         mask_l, pair_mask, e_w, phore_norm, NP, lig3_frozen,
                         trip_frozen):
        """One attention layer (counterpart of `_AttentionLayer`): two node
        updates + bond update + two position updates.
        Returns (new_h, new_h_bond, x)."""
        B, N, H = h.shape
        # Dtypes promote as in the JAX package, where flax's Dense widens
        # bf16 parameters against float32 features: `ph` for what sees h
        # alone, `pw` for what meets the bond grid, which is float32 under
        # bf16 compute without bond diffusion (h is float32 from then on).
        pdt = p["lin_node"]["kernel"].dtype
        hdt = torch.promote_types(h.dtype, pdt)
        wide = torch.promote_types(hdt, h_bond.dtype)
        ph = p if hdt == pdt else _cast_tree(p, hdt)
        pw = p if wide == pdt else _cast_tree(p, wide)
        offsets, coeff = gaussian_smearing_offsets(fix_offset=True)
        # knn edge features: outer(edge_type[4], rbf(d)[20]) -> 80, + type 4
        rel_x = x[:, :, None, :] - gather_nodes(x, nbr_idx)   # x[dst] - x[src]
        dist = torch.sqrt((rel_x * rel_x).sum(-1) + 1e-12)
        # [B,N,K,20], the feature dtype (geometry stays float32)
        dist_feat = gaussian_smearing(dist, offsets, coeff).to(h.dtype)
        outer = (edge_type[..., :, None] * dist_feat[..., None, :]).flatten(-2)
        edge_feat = torch.cat([outer, edge_type.to(outer.dtype)], -1)
        if self.cfg.direction_match:
            # phore norms vs ligand neighbour-centroid norms
            neib = neighbor_centroid_norm(x[:, NP:], mask_l, k=3,
                                          frozen=lig3_frozen)
            comb_norm = torch.cat([phore_norm, neib], 1)      # [B,N,3]
            vec1 = gather_nodes(comb_norm, nbr_idx)           # norm[src]
            vec2 = comb_norm[:, :, None, :]
            vec3 = -rel_x                                     # x[src] - x[dst]
            dire = torch.stack([(vec1 * vec2).sum(-1), (vec1 * vec3).sum(-1),
                                (vec2 * vec3).sum(-1)], -1).to(h.dtype)
            dire = dire.to(hdt) @ ph["dire_embedding"]["kernel"] \
                + ph["dire_embedding"]["bias"]
            edge_feat = torch.cat([edge_feat.to(hdt), dire], -1)

        new_h_with_edge = self.node_knn(ph["node_layer_with_edge"], h.to(hdt),
                                        edge_feat.to(hdt), nbr_idx, nbr_mask,
                                        e_w)
        hw = h.to(wide)
        h_lig = hw[:, NP:]
        if self.cfg.x2h_out_fc:
            # with out_fc the output MLP runs over all composed nodes, so
            # the module runs on the composed graph with the bond grid
            # confined to the ligand block
            hb_full = h_bond.new_zeros(B, N, N, h_bond.shape[-1])
            hb_full[:, NP:, NP:] = h_bond
            pm_full = pair_mask.new_zeros(B, N, N)
            pm_full[:, NP:, NP:] = pair_mask
            new_h_with_bond = self.node_bond(pw["node_layer_with_bond"], hw,
                                             hb_full.to(wide), pm_full)
        else:
            nhb_l = self.node_bond(pw["node_layer_with_bond"], h_lig,
                                   h_bond.to(wide), pair_mask)
            new_h_with_bond = torch.cat([hw.new_zeros(B, NP, H), nhb_l], 1)

        new_h_bond = h_bond + self.bond_update(
            pw["bond_layer"], h_lig, h_bond.to(wide), x[:, NP:], mask_l,
            trip_frozen=trip_frozen).to(h_bond.dtype)
        new_h = hw + ((new_h_with_edge.to(wide) + new_h_with_bond)
                      @ pw["lin_node"]["kernel"] + pw["lin_node"]["bias"])

        dx_edge = self.pos_knn(pw["pos_layer_with_edge"], new_h, rel_x,
                               edge_feat.to(wide), nbr_idx, nbr_mask, e_w)
        pos_l = x[:, NP:]
        rel_bond_x = pos_l[:, None, :, :] - pos_l[:, :, None, :]  # x[dst]-x[src]
        dx_bond_l = self.pos_bond(pw["pos_layer_with_bond"], new_h[:, NP:],
                                  rel_bond_x, new_h_bond.to(wide), pair_mask)
        delta_x = dx_edge + torch.cat([x.new_zeros(B, NP, 3), dx_bond_l], 1)
        lig_atom_mask = torch.cat([mask_l.new_zeros(B, NP), mask_l], 1)
        x = x + delta_x * lig_atom_mask[..., None]
        return new_h, new_h_bond, x
