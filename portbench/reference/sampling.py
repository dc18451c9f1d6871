"""The plain reference of one sampling pool: the phore as the benchmark
reads it, the count-interval head, the phore embedding, and one reverse
step of the sampler (network, categorical posteriors with Gumbel-max
choice, guidance energies and the Gaussian position step), in float32 on
the device it is given. It imports nothing of the measured program.

The step follows the JAX package's and the program's sampler: the node and
bond states carry their log posteriors; the guidance energies are taken at
the step's input positions with the bond classes sampled in this step.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .categorical import CategoricalTransition, build_strided_tables
from .checkpoint import load_weights
from .config import Cfg
from .constants import phore_ex_column
from .gaussian import GaussianTransition, build_gaussian_strided
from .masked import LOG_EPS, masked_mean
from .network import PhoreDiffNet
from .phore import Phore, featurize_phore, parse_phore_file
from .schedules import get_beta_schedule


def cap_phore(phore: Phore, max_points: int, rng: np.random.Generator
              ) -> Phore:
    """Keep every typed (non-EX) feature and a random subset of the EX
    volumes, so that the phore fits `max_points` slots (the rule of the
    JAX package's sampling pipeline)."""
    non_ex = [f for f in phore.features if f.type != "EX"]
    ex = [f for f in phore.features if f.type == "EX"]
    budget = max_points - len(non_ex)
    if budget < 0:
        keep = rng.choice(len(non_ex), size=max_points, replace=False)
        return Phore(phore.name, [non_ex[i] for i in sorted(keep)])
    if len(ex) > budget:
        keep = rng.choice(len(ex), size=budget, replace=False)
        ex = [ex[i] for i in sorted(keep)]
    return Phore(phore.name, non_ex + ex)


def phore_arrays(path: str, data_name: str, max_phore: int, seed: int
                 ) -> Dict[str, np.ndarray]:
    """The phore of `path`, capped to `max_phore` points (EX volumes drawn
    with a generator seeded with `seed`), featurized and centred, padded
    to `max_phore` slots: phore_x, phore_pos, phore_norm, phore_mask,
    center."""
    phore = parse_phore_file(path)
    n_cr = sum(1 for f in phore.features if f.type == "CR")
    if len(phore.features) - n_cr > max_phore:
        phore = cap_phore(phore, max_phore, np.random.default_rng(seed))
    feats, pos, norm, center = featurize_phore(phore, data_name)
    n = len(feats)
    out = {"phore_x": np.zeros((max_phore, feats.shape[1]), np.float32),
           "phore_pos": np.zeros((max_phore, 3), np.float32),
           "phore_norm": np.zeros((max_phore, 3), np.float32),
           "phore_mask": np.zeros(max_phore, bool),
           "center": np.asarray(center, np.float32)}
    out["phore_x"][:n] = feats
    out["phore_pos"][:n] = pos - center
    out["phore_norm"][:n] = norm
    out["phore_mask"][:n] = True
    return out


def pool_batch(phore: Dict[str, np.ndarray], counts: Sequence[int],
               n_lig: int, device) -> Dict[str, torch.Tensor]:
    """One pool's batch: the phore repeated for every graph and a ligand
    mask of `counts[g]` atoms in `n_lig` slots."""
    B = len(counts)
    rep = lambda a: torch.as_tensor(np.repeat(a[None], B, 0), device=device)
    lig_mask = np.arange(n_lig)[None, :] < np.asarray(counts)[:, None]
    return {"phore_x": rep(phore["phore_x"]),
            "phore_pos": rep(phore["phore_pos"]),
            "phore_norm": rep(phore["phore_norm"]),
            "phore_mask": rep(phore["phore_mask"]),
            "center": rep(phore["center"]),
            "lig_mask": torch.as_tensor(lig_mask, device=device)}


def atom_prox_energy(pos, h_edge, bond_mask, min_d, max_d):
    """Hinge on predicted-bond lengths outside [min_d, max_d]: mean over
    each graph's predicted bonds, then over the pool's graphs."""
    is_bond = bond_mask & (h_edge.argmax(-1) > 0)
    d = pos[:, None, :, :] - pos[:, :, None, :]
    blen = torch.sqrt((d * d).sum(-1) + 1e-12)
    hinge = torch.clamp(blen - max_d, min=0.0) + torch.clamp(min_d - blen,
                                                             min=0.0)
    per_graph = masked_mean(hinge, is_bond, dim=(1, 2))
    return per_graph.sum() / per_graph.shape[0]


def center_prox_energy(pos, lig_mask, phore_center):
    """||ligand centroid - non-EX phore centroid||, mean over the pool."""
    centroid = masked_mean(pos, lig_mask[..., None], dim=1)
    per_graph = torch.linalg.norm(centroid - phore_center, dim=-1)
    return per_graph.sum() / per_graph.shape[0]


class RefModel:
    """The release checkpoint `prefix` under `config` (the configuration
    dict as run), in float32 on `device`."""

    def __init__(self, config: Dict, prefix: str, device):
        self.device = torch.device(device)
        cfg = Cfg(config)
        self.cfg = cfg
        mcfg, diff = cfg.model, cfg.model.diff
        T = diff.num_timesteps
        self.T = T
        betas = {k: np.asarray(get_beta_schedule(
            getattr(diff, k).beta_schedule, T,
            **getattr(diff, k).schedule_kwargs()))
            for k in ("diff_pos", "diff_atom", "diff_bond")}
        self.pos_betas = betas["diff_pos"]
        self.node_trans = CategoricalTransition(
            betas["diff_atom"], mcfg.num_atom_classes,
            diff.diff_atom.init_prob)
        self.edge_trans = CategoricalTransition(
            betas["diff_bond"], mcfg.num_bond_classes,
            diff.diff_bond.init_prob)
        self.pos_trans = GaussianTransition(self.pos_betas)
        self.ex_col = phore_ex_column(cfg.dataset.data_name)
        self.net = PhoreDiffNet(mcfg, self.ex_col)
        weights, _ = load_weights(prefix, "cpu")
        self.net.load_state_dict(weights, strict=True)
        self.net.to(self.device).eval()
        # the full schedule: timesteps T-1 .. 0
        ts = np.arange(T - 1, -1, -1, dtype=np.int64)
        tab = lambda a: torch.as_tensor(a, device=self.device)
        self.ts = ts
        self.node_tabs = tuple(map(tab, build_strided_tables(
            betas["diff_atom"], mcfg.num_atom_classes,
            diff.diff_atom.init_prob, ts)))
        self.edge_tabs = tuple(map(tab, build_strided_tables(
            betas["diff_bond"], mcfg.num_bond_classes,
            diff.diff_bond.init_prob, ts)))
        self.gauss = build_gaussian_strided(self.pos_betas, ts)

    @torch.no_grad()
    def count_interval(self, b: Dict[str, torch.Tensor]):
        """(lower, upper) [B, 1] of the normalized atom count."""
        return self.net.count_interval(b["phore_x"], b["phore_pos"],
                                       b["phore_norm"], b["phore_mask"])

    @torch.no_grad()
    def embed_phore(self, b: Dict[str, torch.Tensor]):
        return self.net.embed_phore(b["phore_x"], b["phore_pos"],
                                    b["phore_mask"])

    def phore_center(self, b: Dict[str, torch.Tensor]):
        p_mask = (b["phore_x"][..., self.ex_col] != 1) & b["phore_mask"]
        return masked_mean(b["phore_pos"], p_mask[..., None], dim=1)

    def step(self, state: Dict, i: int, b: Dict[str, torch.Tensor],
             h_phore, draws: Dict, guidance: Sequence[Dict],
             edge_for_energy: Optional[torch.Tensor] = None) -> Dict:
        """Reverse step i from `state` (pos, node, edge, log_node, log_edge)
        with the step's uniforms and normals `draws` (node_u, edge_u,
        pos_noise). `edge_for_energy` (the bond classes sampled in this
        step by the run under test) is what the guidance energies read;
        None: the reference's own. Returns the predictions, the Gumbel
        scores of both categorical draws and the new state."""
        mcfg = self.cfg.model
        S = len(self.ts)
        is_final = i == S - 1
        lig_mask = b["lig_mask"]
        B, NL = lig_mask.shape
        t = torch.full((B,), int(self.ts[i]), dtype=torch.int64,
                       device=self.device)
        oh = torch.nn.functional.one_hot
        h_node = oh(state["node"].long(), mcfg.num_atom_classes).float()
        h_edge = oh(state["edge"].long(), mcfg.num_bond_classes).float()
        with torch.no_grad():
            pred_node, pred_pos, pred_edge, _ = self.net(
                h_node, state["pos"], lig_mask, h_edge, t, b["phore_x"],
                b["phore_pos"], b["phore_norm"], b["phore_mask"],
                h_phore_emb=h_phore, compute_count=False)
        ti = min(i, self.node_tabs[0].shape[0] - 1)
        log_node = self.node_trans.q_v_posterior_mats(
            torch.log_softmax(pred_node, -1), state["log_node"],
            self.node_tabs[0][ti], self.node_tabs[1][ti], is_final)
        log_edge = self.edge_trans.q_v_posterior_mats(
            torch.log_softmax(pred_edge, -1), state["log_edge"],
            self.edge_tabs[0][ti], self.edge_tabs[1][ti], is_final)
        gumbel = lambda u: -torch.log(-torch.log(u + LOG_EPS) + LOG_EPS)
        node_score = log_node + gumbel(draws["node_u"])
        edge_score = log_edge + gumbel(draws["edge_u"])
        node = node_score.argmax(-1)
        edge = edge_score.argmax(-1)
        e_edge = edge if edge_for_energy is None else edge_for_energy
        energy_grad = 0.0
        if guidance:
            eye = torch.eye(NL, dtype=torch.bool, device=self.device)
            bond_mask = lig_mask[:, :, None] & lig_mask[:, None, :] & ~eye
            with torch.enable_grad():
                p = state["pos"].detach().requires_grad_(True)
                e = p.new_zeros(())
                for g in guidance:
                    if g["type"] == "atom_prox":
                        e = e + atom_prox_energy(
                            p, oh(e_edge.long(), mcfg.num_bond_classes),
                            bond_mask, g.get("min_d", 1.0),
                            g.get("max_d", 3.0))
                    elif g["type"] == "center_prox":
                        e = e + center_prox_energy(p, lig_mask,
                                                   self.phore_center(b))
                    else:
                        raise ValueError(f"guidance {g['type']!r}")
                energy_grad, = torch.autograd.grad(e, p)
        cx0, cxt, std = self.gauss
        mu = float(cx0[i]) * pred_pos + float(cxt[i]) * state["pos"] \
            - energy_grad
        pos = mu if is_final else mu + float(std[i]) * draws["pos_noise"]
        return {"pred_node": pred_node, "pred_pos": pred_pos,
                "pred_edge": pred_edge, "node_score": node_score,
                "edge_score": edge_score, "node": node, "edge": edge,
                "log_node": log_node, "log_edge": log_edge, "pos": pos}
