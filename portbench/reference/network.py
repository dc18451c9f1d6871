"""Top-level denoising network (frozen copy of
`phoregen_tpu_torch/models/diffusion_model.py`, per-layer module path):
node/edge embeddings concatenated with the linear-grid time embedding, the
phore self-encoder over the fully connected phore graph, the composed
denoiser, the 12-way node head, the bond head and the [lower, upper]
atom-count interval. Run in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .masked import masked_mean
from .rbf import (gaussian_smearing, gaussian_smearing_offsets,
                       time_smearing, time_smearing_offsets)
from .denoiser import UniDenoiser
from .layers import (Dense, NodeUpdateDense, ParamTree, dtype_of,
                     shifted_softplus)


class PhoreDiffNet(nn.Module):
    def __init__(self, config, ex_col: int):
        super().__init__()
        self.config = config
        self.ex_col = ex_col
        cfg = config
        H, td, d = cfg.hidden_dim, cfg.diff.time_dim, cfg.denoiser
        self.node_embedder = Dense(cfg.num_atom_classes, H - td,
                                   use_bias=False)
        self.phore_embedding = Dense(cfg.phore_feat_dim, H)
        dtype_of(cfg.compute_dtype, "model.compute_dtype")
        if cfg.hp_emb_with_pos:
            self.phore_encoder = ParamTree(NodeUpdateDense.shapes(
                1, H, d.norm, d.x2h_out_fc))
            self._phore_attention = NodeUpdateDense(
                hidden_dim=H, n_heads=d.n_heads, norm=d.norm,
                act_fn=d.act_fn, out_fc=d.x2h_out_fc,
                apply_style=d.edge_mlp_apply)
        if cfg.bond_diffusion:
            self.edge_embedder = Dense(cfg.num_bond_classes, H - td,
                                       use_bias=False)
            bond_in = H if cfg.bond_net_type == "lin" \
                else d.num_r_gaussian + H
            self.bond_inference_0 = Dense(bond_in, H)
            self.bond_inference_2 = Dense(H, cfg.num_bond_classes)
        else:
            # bond features from the pair distance; no bond head
            self.distance_embedding = Dense(1, H - td)
        self.denoiser = UniDenoiser(d)
        self.v_inference_0 = Dense(H, H)
        self.v_inference_2 = Dense(H, cfg.num_atom_classes)
        self.atom_mlp_0 = Dense(H, 2 * H)
        self.atom_mlp_2 = Dense(2 * H, 1)
        self.atom_mlp_1_0 = Dense(H, 2 * H)
        self.atom_mlp_1_2 = Dense(2 * H, 1)
        offs, coeff = time_smearing_offsets(
            0.0, cfg.diff.num_timesteps, td, "linear")
        self.register_buffer("t_off", torch.as_tensor(offs), persistent=False)
        self.register_buffer("t_coeff", torch.as_tensor(coeff),
                             persistent=False)

    def _time_embed(self, t: torch.Tensor) -> torch.Tensor:
        return time_smearing(t, self.t_off, self.t_coeff, 0.0,
                             self.config.diff.num_timesteps)

    def embed_phore(self, phore_x, phore_pos, phore_mask):
        h = self.phore_embedding(phore_x)
        if self.config.hp_emb_with_pos:
            d = phore_pos[:, :, None, :] - phore_pos[:, None, :, :]
            dist = torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-12)
            pmask = phore_mask[:, :, None] & phore_mask[:, None, :]
            h = self._phore_attention(self.phore_encoder.tree(), h,
                                      dist.to(h.dtype), pmask)
        return h

    def predict_atom_count(self, h_p, raw_phore_x, phore_mask):
        """[lower, upper] interval over the normalized atom count, [B, 1];
        float32 whatever the compute dtype (bf16 parameters are widened by
        `Dense`)."""
        h_p = h_p.float()
        count_all = torch.sigmoid(self.atom_mlp_2(torch.relu(
            self.atom_mlp_0(h_p))))
        count_all = masked_mean(count_all, phore_mask[..., None], dim=1)
        mask_nonex = (raw_phore_x[..., self.ex_col] != 1) & phore_mask
        count_l = torch.sigmoid(self.atom_mlp_1_2(torch.relu(
            self.atom_mlp_1_0(h_p))))
        count_l = masked_mean(count_l, mask_nonex[..., None], dim=1)
        return count_l, count_l + torch.relu(count_all - count_l)

    def count_interval(self, phore_x, phore_pos, phore_norm, phore_mask):
        del phore_norm
        h_p = self.embed_phore(phore_x, phore_pos, phore_mask)
        return self.predict_atom_count(h_p, phore_x, phore_mask)

    def forward(self, h_node_pert, pos_pert, lig_mask, h_edge_pert, t,
                phore_x, phore_pos, phore_norm, phore_mask,
                h_phore_emb: Optional[torch.Tensor] = None,
                compute_count: bool = True):
        """Returns (pred_node [B,NL,Ka], pred_pos [B,NL,3],
        pred_edge [B,NL,NL,Kb] (None without `bond_diffusion`, where the
        bond features come from the pair distances and `h_edge_pert` is
        unused), (count_lower, count_upper) or (None, None))."""
        cfg = self.config
        B, NL, _ = h_node_pert.shape
        NP = phore_x.shape[1]
        H, td = cfg.hidden_dim, cfg.diff.time_dim
        # the compute dtype follows the features; geometry stays float32
        cdt = h_node_pert.dtype
        t_emb = self._time_embed(t).to(cdt)
        h_node = torch.cat([self.node_embedder(h_node_pert),
                            t_emb[:, None, :].expand(B, NL, td)], -1)
        if h_phore_emb is None:
            h_phore_emb = self.embed_phore(phore_x, phore_pos, phore_mask)
        else:
            h_phore_emb = h_phore_emb.to(cdt)
        if cfg.bond_diffusion:
            e_emb = self.edge_embedder(h_edge_pert)
        else:
            d = pos_pert[:, None, :, :] - pos_pert[:, :, None, :]
            # the float32 distance meets the (bf16) kernel in `Dense`,
            # which computes in float32 as flax does
            e_emb = self.distance_embedding(
                torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-12))
        # the concatenation promotes as the JAX package's does: under bf16
        # without bond diffusion the float32 distance embedding makes
        # h_edge, and the bond path after it, float32
        edt = torch.promote_types(e_emb.dtype, t_emb.dtype)
        h_edge = torch.cat([e_emb.to(edt), t_emb[:, None, None, :].expand(
            B, NL, NL, td).to(edt)], -1)
        h_all = torch.cat([h_phore_emb, h_node], 1)
        pos_all = torch.cat([phore_pos, pos_pert], 1)
        node_mask = torch.cat([phore_mask, lig_mask], 1)
        h_out, x_out, hb_out = self.denoiser(
            h_all, pos_all, h_edge, node_mask, phore_norm, NP)
        final_pos = x_out[:, NP:]
        final_h = h_out[:, NP:]
        pred_node = self.v_inference_2(shifted_softplus(
            self.v_inference_0(final_h)))
        pred_count = (self.predict_atom_count(h_phore_emb, phore_x,
                                              phore_mask)
                      if compute_count else (None, None))
        if not cfg.bond_diffusion:
            return pred_node, final_pos, None, pred_count
        if cfg.bond_net_type == "lin":
            bond_in = hb_out
        elif cfg.bond_net_type == "pre_att":
            offs, coeff = gaussian_smearing_offsets(
                0.0, 5.0, num_gaussians=cfg.denoiser.num_r_gaussian,
                fix_offset=False)
            d = final_pos[:, None, :, :] - final_pos[:, :, None, :]
            dist = torch.sqrt((d * d).sum(-1) + 1e-12)
            hij = (final_h[:, None, :, :] + final_h[:, :, None, :]) / 2
            # the feature dtype, like every position-derived feature
            r_feat = gaussian_smearing(dist, offs, coeff).to(final_h.dtype)
            bond_in = torch.cat([r_feat, hij], -1)
        else:
            raise ValueError(cfg.bond_net_type)
        pred_edge = self.bond_inference_2(shifted_softplus(
            self.bond_inference_0(bond_in)))
        return pred_node, final_pos, pred_edge, pred_count
