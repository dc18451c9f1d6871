"""Reverse-diffusion sampling as a Python loop over steps.

Counterpart of `phoregen_tpu/sample/sampler.py::Sampler`: atom-count
interval prediction, per-graph count draws, prior draws for positions,
atom and bond types, then the reverse loop (categorical posteriors with
Gumbel-max sampling, the Gaussian position posterior with the optional
guidance energies' gradient subtracted from its mean). The phore embedding
and the packed layer-stack weights are loop-invariant and computed once
before the loop. Random draws come from an explicit `torch.Generator`; a
test can inject them per step (`step(..., draws=...)`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import MAX_ATOMS, MIN_ATOMS
from ..data.batching import PhoreGraphBatch
from ..diffusion.categorical import build_strided_tables
from ..diffusion.gaussian import GaussianTransition, build_gaussian_strided
from ..ops.masked import log_sample_categorical, masked_mean


@dataclasses.dataclass(frozen=True)
class GuidanceOpt:
    """One guidance drift spec (CLI `--pos_guidance_opt` JSON items)."""
    type: str                 # 'atom_prox' | 'center_prox'
    min_d: float = 1.0
    max_d: float = 3.0
    sigma: float = 1.2
    weight: float = 1.0


def atom_prox_energy(pos, h_edge, bond_mask, lig_mask, min_d, max_d):
    """Hinge energy on predicted-bond lengths outside [min_d, max_d]: mean
    over each graph's predicted bonds, then over graphs."""
    del lig_mask
    is_bond = bond_mask & (h_edge.argmax(-1) > 0)
    d = pos[:, None, :, :] - pos[:, :, None, :]
    blen = torch.sqrt((d * d).sum(-1) + 1e-12)
    hinge = torch.clamp(blen - max_d, min=0.0) + torch.clamp(min_d - blen,
                                                             min=0.0)
    return masked_mean(hinge, is_bond, dim=(1, 2)).mean()


def center_prox_energy(pos, lig_mask, phore_center):
    """||ligand centroid - non-EX phore centroid|| per graph, averaged."""
    centroid = masked_mean(pos, lig_mask[..., None], dim=1)
    return torch.linalg.norm(centroid - phore_center, dim=-1).mean()


class Sampler:
    def __init__(self, pg, guidance: Optional[Sequence[GuidanceOpt]] = None,
                 sample_steps: int = 0):
        self.pg = pg
        self.guidance = tuple(guidance) if guidance else ()
        for g in self.guidance:
            if g.type not in ("atom_prox", "center_prox"):
                raise NotImplementedError(
                    f"guidance {g.type!r} is not ported yet "
                    "(supported: atom_prox, center_prox)")
        if not (sample_steps == 0 or sample_steps >= 2):
            raise ValueError("sample_steps must be 0 (full schedule) or >= 2")
        self.sample_steps = sample_steps
        self._sched = {}

    @property
    def device(self):
        return next(self.pg.net.parameters()).device

    # ----- atom count interval -----
    @torch.no_grad()
    def predict_count_interval(self, batch: PhoreGraphBatch
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Integer [lower, upper] per graph."""
        lo, up = self.pg.net.count_interval(batch.phore_x, batch.phore_pos,
                                            batch.phore_norm, batch.phore_mask)
        denorm = lambda c: torch.round(
            c * (MAX_ATOMS - MIN_ATOMS) + MIN_ATOMS).to(torch.int32)
        return denorm(lo[:, 0]), denorm(up[:, 0])

    @staticmethod
    def sample_counts(rng: np.random.Generator, lower: int, upper: int,
                      batch_size: int, mode: str = "uniform",
                      scale: float = 4.0) -> np.ndarray:
        """Per-graph atom counts from the predicted interval."""
        if mode == "uniform":
            return rng.integers(lower, upper + 1, size=batch_size
                                ).astype(np.int32)
        if mode == "normal":
            mid = (lower + upper) / 2.0
            std = (upper - lower) / scale
            x = mid + std * rng.normal(size=batch_size)
            return np.clip(np.round(x), lower, upper).astype(np.int32)
        raise NotImplementedError(mode)

    # ----- strided schedule -----
    def schedule(self):
        """(timesteps [S], node (trans_T, cum_prev) [S-1,K,K], edge tables,
        gaussian (coef_x0, coef_xt, std) [S]) on the sampler's device."""
        pg = self.pg
        T = pg.num_timesteps
        S = self.sample_steps if 0 < self.sample_steps < T else T
        if S not in self._sched:
            ts = np.unique(np.round(np.linspace(T - 1, 0, S)).astype(np.int64))
            ts = ts[::-1].copy()
            mcfg, diff = pg.config.model, pg.config.model.diff
            dev = self.device
            tab = lambda a: torch.as_tensor(a, device=dev)
            node = tuple(map(tab, build_strided_tables(
                pg.node_betas, mcfg.num_atom_classes,
                diff.diff_atom.init_prob, ts)))
            edge = tuple(map(tab, build_strided_tables(
                pg.edge_betas, mcfg.num_bond_classes,
                diff.diff_bond.init_prob, ts)))
            gauss = build_gaussian_strided(pg.pos_betas, ts)
            self._sched[S] = (ts, node, edge, gauss)
        return self._sched[S]

    # ----- the reverse loop -----
    def prepare(self, batch: PhoreGraphBatch) -> Dict:
        """Loop invariants: phore embedding, packed stack weights, the
        non-EX phore centroid for center_prox."""
        pg = self.pg
        p_mask = (batch.phore_x[..., pg.ex_col] != 1) & batch.phore_mask
        with torch.no_grad():
            h_phore = pg.net.embed_phore(batch.phore_x, batch.phore_pos,
                                         batch.phore_mask)
            packed = pg.net.pack_fused()
        return {"h_phore": h_phore, "packed": packed,
                "phore_center": masked_mean(batch.phore_pos,
                                            p_mask[..., None], dim=1)}

    def energy(self, pos, edge_ids, batch, phore_center):
        e = pos.new_zeros(())
        Kb = self.pg.config.model.num_bond_classes
        for g in self.guidance:
            if g.type == "atom_prox":
                h_edge = torch.nn.functional.one_hot(edge_ids.long(), Kb)
                e = e + atom_prox_energy(pos, h_edge, batch.bond_mask,
                                         batch.lig_mask, g.min_d, g.max_d)
            elif g.type == "center_prox":
                e = e + center_prox_energy(pos, batch.lig_mask, phore_center)
        return e

    def init_state(self, batch: PhoreGraphBatch,
                   generator: Optional[torch.Generator] = None,
                   offset_init_by_center: bool = False) -> Dict:
        pg = self.pg
        B, NL = batch.lig_mask.shape
        dev = batch.lig_mask.device
        pos = pg.pos_transition.sample_init((B, NL, 3), generator, dev)
        if offset_init_by_center:
            pos = pos - batch.center[:, None, :]
        node, _, log_node = pg.node_transition.sample_init((B, NL), generator,
                                                           dev)
        edge, _, log_edge = pg.edge_transition.sample_init((B, NL, NL),
                                                           generator, dev)
        return {"pos": pos, "node": node, "log_node": log_node,
                "edge": edge, "log_edge": log_edge}

    def step(self, state: Dict, i: int, batch: PhoreGraphBatch, inv: Dict,
             is_final: bool, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict] = None):
        """One reverse step i of the schedule. `draws` may hold the step's
        random numbers ('node_u', 'edge_u' uniforms, 'pos_noise' normals).
        Returns (new state, (pred_node, pred_pos, pred_edge))."""
        pg = self.pg
        mcfg = pg.config.model
        ts, (node_tT, node_cp), (edge_tT, edge_cp), (cx0, cxt, std) = \
            self.schedule()
        draws = draws or {}
        B = batch.lig_mask.shape[0]
        t = torch.full((B,), int(ts[i]), dtype=torch.int64,
                       device=batch.lig_mask.device)
        oh = torch.nn.functional.one_hot
        with torch.no_grad():
            pred_node, pred_pos, pred_edge, _ = pg.net(
                oh(state["node"].long(), mcfg.num_atom_classes).float(),
                state["pos"], batch.lig_mask,
                oh(state["edge"].long(), mcfg.num_bond_classes).float(), t,
                batch.phore_x, batch.phore_pos, batch.phore_norm,
                batch.phore_mask, h_phore_emb=inv["h_phore"],
                compute_count=False, fused_packed=inv["packed"])
        ti = min(i, node_tT.shape[0] - 1)
        log_node = pg.node_transition.q_v_posterior_mats(
            torch.log_softmax(pred_node, -1), state["log_node"],
            node_tT[ti], node_cp[ti], is_final)
        node = log_sample_categorical(log_node, generator,
                                      draws.get("node_u"))
        log_edge = pg.edge_transition.q_v_posterior_mats(
            torch.log_softmax(pred_edge, -1), state["log_edge"],
            edge_tT[ti], edge_cp[ti], is_final)
        edge = log_sample_categorical(log_edge, generator,
                                      draws.get("edge_u"))
        energy_grad = 0.0
        if self.guidance:
            with torch.enable_grad():
                p = state["pos"].detach().requires_grad_(True)
                energy_grad, = torch.autograd.grad(
                    self.energy(p, edge, batch, inv["phore_center"]), p)
        pos = GaussianTransition.get_prev_with(
            state["pos"], pred_pos, float(cx0[i]), float(cxt[i]),
            float(std[i]), is_final, energy_grad=energy_grad,
            generator=generator, noise=draws.get("pos_noise"))
        new = {"pos": pos, "node": node, "log_node": log_node, "edge": edge,
               "log_edge": log_edge}
        return new, (pred_node, pred_pos, pred_edge)

    def sample(self, batch: PhoreGraphBatch,
               generator: Optional[torch.Generator] = None,
               offset_init_by_center: bool = False) -> Dict:
        """The full reverse process for a padded sampling batch (replicated
        phore, per-graph lig_mask); ligand content of `batch` is ignored."""
        ts = self.schedule()[0]
        S = len(ts)
        inv = self.prepare(batch)
        state = self.init_state(batch, generator, offset_init_by_center)
        for i in range(S - 1):
            state, _ = self.step(state, i, batch, inv, False, generator)
        state, preds = self.step(state, S - 1, batch, inv, True, generator)
        pred_node, pred_pos, pred_edge = preds
        center = batch.center[:, None, :]
        return {
            "pred_node": pred_node, "pred_pos": pred_pos + center,
            "pred_edge": pred_edge, "lig_mask": batch.lig_mask,
            "final_state": {"pos": state["pos"] + center,
                            "node": state["node"], "edge": state["edge"]},
        }
