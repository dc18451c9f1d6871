"""Top-level denoising network: embedders, denoiser, prediction heads.

Counterpart of `phoregen_tpu/models/diffusion_model.py::PhoreDiffNet`:
node/edge embeddings concatenated with the linear-grid time embedding, the
phore self-encoder over the fully connected phore graph, the composed
denoiser (fused layer stack), the 12-way node head, the bond head ('lin' or
'pre_att') and the [lower, upper] atom-count interval.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.masked import masked_mean
from ..ops.rbf import (gaussian_smearing, gaussian_smearing_offsets,
                       time_smearing, time_smearing_offsets)
from .denoiser import UniDenoiser
from .layers import Dense, NodeUpdateDense, shifted_softplus


class PhoreDiffNet(nn.Module):
    def __init__(self, config, ex_col: int):
        super().__init__()
        self.config = config
        self.ex_col = ex_col
        cfg = config
        H, td, d = cfg.hidden_dim, cfg.diff.time_dim, cfg.denoiser
        if not cfg.bond_diffusion:
            raise NotImplementedError(
                "bond_diffusion=False (distance embedding) is not ported yet")
        self.node_embedder = Dense(cfg.num_atom_classes, H - td,
                                   use_bias=False)
        self.phore_embedding = Dense(cfg.phore_feat_dim, H)
        if cfg.hp_emb_with_pos:
            self.phore_encoder = NodeUpdateDense(1, H, d.n_heads, d.norm)
        self.edge_embedder = Dense(cfg.num_bond_classes, H - td,
                                   use_bias=False)
        bond_in = H if cfg.bond_net_type == "lin" else d.num_r_gaussian + H
        self.bond_inference_0 = Dense(bond_in, H)
        self.bond_inference_2 = Dense(H, cfg.num_bond_classes)
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
            h = self.phore_encoder(h, dist, pmask)
        return h

    def predict_atom_count(self, h_p, raw_phore_x, phore_mask):
        """[lower, upper] interval over the normalized atom count, [B, 1]."""
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

    def pack_fused(self):
        return self.denoiser.pack_fused()

    def forward(self, h_node_pert, pos_pert, lig_mask, h_edge_pert, t,
                phore_x, phore_pos, phore_norm, phore_mask,
                h_phore_emb: Optional[torch.Tensor] = None,
                compute_count: bool = True, fused_packed=None):
        """Returns (pred_node [B,NL,Ka], pred_pos [B,NL,3],
        pred_edge [B,NL,NL,Kb], (count_lower, count_upper) or (None, None))."""
        cfg = self.config
        B, NL, _ = h_node_pert.shape
        NP = phore_x.shape[1]
        H, td = cfg.hidden_dim, cfg.diff.time_dim
        t_emb = self._time_embed(t)
        h_node = torch.cat([self.node_embedder(h_node_pert),
                            t_emb[:, None, :].expand(B, NL, td)], -1)
        if h_phore_emb is None:
            h_phore_emb = self.embed_phore(phore_x, phore_pos, phore_mask)
        h_edge = torch.cat([self.edge_embedder(h_edge_pert),
                            t_emb[:, None, None, :].expand(B, NL, NL, td)],
                           -1)
        h_all = torch.cat([h_phore_emb, h_node], 1)
        pos_all = torch.cat([phore_pos, pos_pert], 1)
        node_mask = torch.cat([phore_mask, lig_mask], 1)
        h_out, x_out, hb_out = self.denoiser(
            h_all, pos_all, h_edge, node_mask, phore_norm, NP,
            packed=fused_packed)
        final_pos = x_out[:, NP:]
        final_h = h_out[:, NP:]
        pred_node = self.v_inference_2(shifted_softplus(
            self.v_inference_0(final_h)))
        if cfg.bond_net_type == "lin":
            bond_in = hb_out
        elif cfg.bond_net_type == "pre_att":
            offs, coeff = gaussian_smearing_offsets(
                0.0, 5.0, num_gaussians=cfg.denoiser.num_r_gaussian,
                fix_offset=False)
            d = final_pos[:, None, :, :] - final_pos[:, :, None, :]
            dist = torch.sqrt((d * d).sum(-1) + 1e-12)
            hij = (final_h[:, None, :, :] + final_h[:, :, None, :]) / 2
            bond_in = torch.cat([gaussian_smearing(dist, offs, coeff), hij],
                                -1)
        else:
            raise ValueError(cfg.bond_net_type)
        pred_edge = self.bond_inference_2(shifted_softplus(
            self.bond_inference_0(bond_in)))
        pred_count = (self.predict_atom_count(h_phore_emb, phore_x,
                                              phore_mask)
                      if compute_count else (None, None))
        return pred_node, final_pos, pred_edge, pred_count
