"""Reverse-diffusion sampling as a Python loop over steps.

Counterpart of `phoregen_tpu/sample/sampler.py::Sampler`: atom-count
interval prediction, per-graph count draws, prior draws for positions,
atom and bond types, then the reverse loop (categorical posteriors with
Gumbel-max sampling, or with `categorical_space: continuous` the Gaussian
posterior on the relaxed one-hots; the Gaussian position posterior with
the optional guidance energies' gradient subtracted from its mean). Without
`bond_diffusion` the bond state keeps its prior draw, atom_prox guidance is
skipped (as in the JAX package) and `pred_edge` is None. The phore
embedding and, for a fused stack, the packed layer-stack weights are
loop-invariant and computed once before the loop. Random draws come from
an explicit `torch.Generator`; a test can inject them per step
(`step(..., draws=...)`).

`sample(chunk_steps=n)` (`sample_chunked`) runs the same steps with the
host waiting for the card every n steps, where the JAX package splits its
scan into device calls: the same per-step calls, the state left on the
card, bit for bit the same outputs and generator stream. The JAX
sampler's `unroll` (XLA's scan unrolling) has no counterpart: the loop
here is a Python loop.

A pool sharded over devices (`sample/pipeline.py`) runs one reverse
process per shard in lockstep (`steps`, `sample_lockstep`): a shard draws
its rows of the pool's draws (`ops/draws.BatchRows`) and its guidance
energies divide by the pool's size, as the JAX package's batch means over
a sharded pool do, so its rows equal those of the unsharded pool.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..constants import MAX_ATOMS, MIN_ATOMS
from ..data.batching import PhoreGraphBatch
from ..diffusion.categorical import build_strided_tables
from ..diffusion.gaussian import GaussianTransition, build_gaussian_strided
from ..models.diffusion_model import apply_net, cast_params
from ..models.layers import dtype_of
from ..ops.masked import log_sample_categorical, masked_mean


@dataclasses.dataclass(frozen=True)
class GuidanceOpt:
    """One guidance drift spec (CLI `--pos_guidance_opt` JSON items)."""
    type: str                 # 'atom_prox' | 'center_prox' | 'frag_attract'
    min_d: float = 1.0
    max_d: float = 3.0
    sigma: float = 1.2        # frag_attract: adjacency kernel scale (A)
    weight: float = 1.0       # frag_attract: energy scale


def _pool_mean(per_graph, pool_size: Optional[int]):
    """Mean over the graphs of the pool: `pool_size` None = this batch is
    the pool; a shard of a pool passes the pool's size, so that its rows
    of the energy gradient are those of the whole pool's."""
    n = per_graph.shape[0] if pool_size is None else pool_size
    return per_graph.sum() / n


def atom_prox_energy(pos, h_edge, bond_mask, lig_mask, min_d, max_d,
                     pool_size: Optional[int] = None):
    """Hinge energy on predicted-bond lengths outside [min_d, max_d]: mean
    over each graph's predicted bonds, then over the pool's graphs."""
    del lig_mask
    is_bond = bond_mask & (h_edge.argmax(-1) > 0)
    d = pos[:, None, :, :] - pos[:, :, None, :]
    blen = torch.sqrt((d * d).sum(-1) + 1e-12)
    hinge = torch.clamp(blen - max_d, min=0.0) + torch.clamp(min_d - blen,
                                                             min=0.0)
    return _pool_mean(masked_mean(hinge, is_bond, dim=(1, 2)), pool_size)


def frag_attract_energy(pos, lig_mask, sigma=1.2, weight=1.0, n_hops=7,
                        pool_size: Optional[int] = None):
    """Differentiable connectivity energy: the share of a molecule that a
    soft diffusion from the centroid-nearest atom cannot reach.

    Soft adjacency W = 1 / (1 + (d^2 / sigma^2)^3), row-normalised over
    valid atoms; reachability r = seed @ W^(2^n_hops) by repeated squaring;
    energy = 4 * sum of relu(0.25 / n_valid - r) per graph, averaged over
    the pool. A connected cluster gives about 0, a split one about the far
    cluster's share, with gradients through the inter-cluster distances."""
    N = pos.shape[1]
    maskf = lig_mask.to(pos.dtype)
    d = pos[:, :, None, :] - pos[:, None, :, :]
    u = (d * d).sum(-1) / (sigma * sigma)
    W = 1.0 / (1.0 + u * u * u)
    W = W * maskf[:, None, :] * maskf[:, :, None]
    W = W / torch.clamp(W.sum(-1, keepdim=True), min=1e-12)
    centroid = masked_mean(pos, lig_mask[..., None], dim=1)
    dc = ((pos - centroid[:, None, :]) ** 2).sum(-1)
    dc = torch.where(lig_mask.to(torch.bool), dc,
                     torch.full_like(dc, float("inf")))
    seed = torch.nn.functional.one_hot(dc.argmin(1), N).to(pos.dtype)
    for _ in range(n_hops):
        W = W @ W
    r = torch.einsum("bn,bnm->bm", seed, W)
    n_valid = torch.clamp(maskf.sum(-1), min=1.0)
    thresh = 0.25 / n_valid[:, None]
    unreached = (torch.relu(thresh - r) * maskf).sum(-1) * 4.0
    return weight * _pool_mean(unreached, pool_size)


def center_prox_energy(pos, lig_mask, phore_center,
                       pool_size: Optional[int] = None):
    """||ligand centroid - non-EX phore centroid|| per graph, averaged
    over the pool."""
    centroid = masked_mean(pos, lig_mask[..., None], dim=1)
    return _pool_mean(torch.linalg.norm(centroid - phore_center, dim=-1),
                      pool_size)


class Sampler:
    def __init__(self, pg, guidance: Optional[Sequence[GuidanceOpt]] = None,
                 keep_traj: bool = False, sample_steps: int = 0):
        self.pg = pg
        self.guidance = tuple(guidance) if guidance else ()
        for g in self.guidance:
            if g.type not in ("atom_prox", "center_prox", "frag_attract"):
                raise ValueError(
                    f"unknown guidance {g.type!r} (supported: atom_prox, "
                    "center_prox, frag_attract)")
        self.keep_traj = keep_traj
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
        """(timesteps [S], node tables, edge tables, position (coef_x0,
        coef_xt, std) [S] numpy). Categorical tables: (trans_T, cum_prev)
        [S-1,K,K] on the sampler's device; continuous: the Gaussian
        (coef_x0, coef_xt, std) [S] of the node and edge schedules."""
        pg = self.pg
        T = pg.num_timesteps
        S = self.sample_steps if 0 < self.sample_steps < T else T
        if S not in self._sched:
            ts = np.unique(np.round(np.linspace(T - 1, 0, S)).astype(np.int64))
            ts = ts[::-1].copy()
            mcfg, diff = pg.config.model, pg.config.model.diff
            dev = self.device
            tab = lambda a: torch.as_tensor(a, device=dev)
            if pg.categorical_space == "discrete":
                node = tuple(map(tab, build_strided_tables(
                    pg.node_betas, mcfg.num_atom_classes,
                    diff.diff_atom.init_prob, ts)))
                edge = tuple(map(tab, build_strided_tables(
                    pg.edge_betas, mcfg.num_bond_classes,
                    diff.diff_bond.init_prob, ts)))
            else:   # Gaussian coefficients per category channel
                node = build_gaussian_strided(pg.node_betas, ts)
                edge = build_gaussian_strided(pg.edge_betas, ts)
            gauss = build_gaussian_strided(pg.pos_betas, ts)
            self._sched[S] = (ts, node, edge, gauss)
        return self._sched[S]

    # ----- the reverse loop -----
    def prepare(self, batch: PhoreGraphBatch) -> Dict:
        """Loop invariants: the network's parameters in the compute dtype
        (`model.compute_dtype`; cast once a run, None at float32), the
        phore embedding and the packed weights of a fused stack (None on
        the per-layer module path), both made from those parameters, and
        the non-EX phore centroid for center_prox."""
        pg = self.pg
        cdt = dtype_of(pg.config.model.compute_dtype)
        p_mask = (batch.phore_x[..., pg.ex_col] != 1) & batch.phore_mask
        with torch.no_grad():
            params = cast_params(pg.net, cdt)
            h_phore = apply_net(pg.net, params, batch.phore_x.to(cdt),
                                batch.phore_pos, batch.phore_mask,
                                method="embed_phore")
            packed = apply_net(pg.net, params, method="pack_fused")
        return {"params": params, "dtype": cdt, "h_phore": h_phore,
                "packed": packed,
                "phore_center": masked_mean(batch.phore_pos,
                                            p_mask[..., None], dim=1)}

    def energy(self, pos, edge, batch, phore_center,
               pool_size: Optional[int] = None):
        """Sum of the guidance energies, each a mean over the pool's graphs
        (`pool_size`; None = `batch` is the pool); `edge` is the bond state
        (class ids, or relaxed one-hots in the continuous space). atom_prox
        needs predicted bonds and is skipped without `bond_diffusion`."""
        e = pos.new_zeros(())
        mcfg = self.pg.config.model
        for g in self.guidance:
            if g.type == "atom_prox":
                if not mcfg.bond_diffusion:
                    continue
                h_edge = edge if edge.is_floating_point() else \
                    torch.nn.functional.one_hot(edge.long(),
                                                mcfg.num_bond_classes)
                e = e + atom_prox_energy(pos, h_edge, batch.bond_mask,
                                         batch.lig_mask, g.min_d, g.max_d,
                                         pool_size)
            elif g.type == "center_prox":
                e = e + center_prox_energy(pos, batch.lig_mask, phore_center,
                                           pool_size)
            elif g.type == "frag_attract":
                e = e + frag_attract_energy(pos, batch.lig_mask, g.sigma,
                                            g.weight, pool_size=pool_size)
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
        if pg.categorical_space == "discrete":
            node, _, log_node = pg.node_transition.sample_init(
                (B, NL), generator, dev)
            edge, _, log_edge = pg.edge_transition.sample_init(
                (B, NL, NL), generator, dev)
        else:   # relaxed one-hots [.., K], no log-probabilities
            node = pg.node_transition.sample_init((B, NL), generator, dev)
            edge = pg.edge_transition.sample_init((B, NL, NL), generator,
                                                  dev)
            log_node = log_edge = None
        return {"pos": pos, "node": node, "log_node": log_node,
                "edge": edge, "log_edge": log_edge}

    def step(self, state: Dict, i: int, batch: PhoreGraphBatch, inv: Dict,
             is_final: bool, generator: Optional[torch.Generator] = None,
             draws: Optional[Dict] = None):
        """One reverse step i of the schedule. `draws` may hold the step's
        random numbers ('node_u', 'edge_u' uniforms of the categorical
        sampling, or 'node_noise', 'edge_noise' normals of the continuous
        one; 'pos_noise' normals). Returns (new state, (pred_node,
        pred_pos, pred_edge))."""
        with record_function("sample.step"):
            pg = self.pg
            mcfg = pg.config.model
            discrete = pg.categorical_space == "discrete"
            ts, node_tabs, edge_tabs, (cx0, cxt, std) = self.schedule()
            draws = draws or {}
            B = batch.lig_mask.shape[0]
            t = torch.full((B,), int(ts[i]), dtype=torch.int64,
                           device=batch.lig_mask.device)
            cdt = inv["dtype"]
            if discrete:
                oh = torch.nn.functional.one_hot
                h_node = oh(state["node"].long(), mcfg.num_atom_classes)
                h_edge = oh(state["edge"].long(), mcfg.num_bond_classes)
            else:
                h_node, h_edge = state["node"], state["edge"]
            with torch.no_grad(), record_function("sample.network"):
                preds = apply_net(
                    pg.net, inv["params"], h_node.to(cdt), state["pos"],
                    batch.lig_mask, h_edge.to(cdt), t, batch.phore_x.to(cdt),
                    batch.phore_pos, batch.phore_norm, batch.phore_mask,
                    h_phore_emb=inv["h_phore"], compute_count=False,
                    fused_packed=inv["packed"])
            with record_function("sample.posterior"):
                # posteriors, positions and sampling in float32
                pred_node, pred_pos, pred_edge = (
                    None if p is None else p.float() for p in preds[:3])
                edge, log_edge = state["edge"], state["log_edge"]
                if discrete:
                    ti = min(i, node_tabs[0].shape[0] - 1)
                    log_node = pg.node_transition.q_v_posterior_mats(
                        torch.log_softmax(pred_node, -1), state["log_node"],
                        node_tabs[0][ti], node_tabs[1][ti], is_final)
                    node = log_sample_categorical(log_node, generator,
                                                  draws.get("node_u"))
                    if mcfg.bond_diffusion:
                        log_edge = pg.edge_transition.q_v_posterior_mats(
                            torch.log_softmax(pred_edge, -1), log_edge,
                            edge_tabs[0][ti], edge_tabs[1][ti], is_final)
                        edge = log_sample_categorical(log_edge, generator,
                                                      draws.get("edge_u"))
                else:
                    # the Gaussian reverse step on the relaxed one-hots
                    def gauss_step(x, pred, tabs, noise):
                        return GaussianTransition.get_prev_with(
                            x, pred, float(tabs[0][i]), float(tabs[1][i]),
                            float(tabs[2][i]), is_final, generator=generator,
                            noise=noise)
                    log_node = None
                    node = gauss_step(state["node"], pred_node, node_tabs,
                                      draws.get("node_noise"))
                    if mcfg.bond_diffusion:
                        edge = gauss_step(edge, pred_edge, edge_tabs,
                                          draws.get("edge_noise"))
            energy_grad = 0.0
            if self.guidance:
                with torch.enable_grad(), record_function("sample.guidance"):
                    p = state["pos"].detach().requires_grad_(True)
                    e = self.energy(p, edge, batch, inv["phore_center"],
                                    inv.get("pool_size"))
                    # no energy term left (atom_prox alone without bonds)
                    if e.requires_grad:
                        energy_grad, = torch.autograd.grad(e, p)
            with record_function("sample.position"):
                pos = GaussianTransition.get_prev_with(
                    state["pos"], pred_pos, float(cx0[i]), float(cxt[i]),
                    float(std[i]), is_final, energy_grad=energy_grad,
                    generator=generator, noise=draws.get("pos_noise"))
            new = {"pos": pos, "node": node, "log_node": log_node,
                   "edge": edge, "log_edge": log_edge}
            return new, (pred_node, pred_pos, pred_edge)

    def sample(self, batch: PhoreGraphBatch,
               generator: Optional[torch.Generator] = None,
               offset_init_by_center: bool = False,
               chunk_steps: int = 0, pool_size: Optional[int] = None
               ) -> Dict:
        """The full reverse process for a padded sampling batch (replicated
        phore, per-graph lig_mask); ligand content of `batch` is ignored.
        With `keep_traj` the result also holds 'traj': the sampled node and
        edge states (class ids as int8, or the continuous space's relaxed
        one-hots) and positions of the prior draw and of every step, each
        [S+1, B, ...]. `chunk_steps` > 0: the host waits for the card
        after every `chunk_steps` of the first S-1 steps and before the
        final one, as the JAX package's `sample_chunked` makes a device
        call of each; nothing else changes. A shard of a pool passes
        `generator` as `ops/draws.BatchRows` (its rows of the pool's draws)
        and the pool's size as `pool_size` (the guidance means' divisor):
        see `sample_lockstep`."""
        return sample_lockstep([(batch.lig_mask.device, self.steps(
            batch, generator, offset_init_by_center, chunk_steps,
            pool_size))])[0]

    def steps(self, batch: PhoreGraphBatch, generator=None,
              offset_init_by_center: bool = False, chunk_steps: int = 0,
              pool_size: Optional[int] = None):
        """`sample` as a Python generator that yields after every reverse
        step and returns the result (`sample_lockstep` drives it)."""
        ts = self.schedule()[0]
        S = len(ts)
        inv = self.prepare(batch)
        inv["pool_size"] = pool_size
        state = self.init_state(batch, generator, offset_init_by_center)
        center = batch.center[:, None, :]
        frames = [state] if self.keep_traj else None
        chunk = max(1, min(chunk_steps, S - 1)) if chunk_steps > 0 else 0
        for i in range(S):
            if chunk and i > 0 and (i % chunk == 0 or i == S - 1) \
                    and state["pos"].is_cuda:
                torch.cuda.synchronize(state["pos"].device)
            state, preds = self.step(state, i, batch, inv, i == S - 1,
                                     generator)
            if frames is not None:
                frames.append(state)
            yield
        pred_node, pred_pos, pred_edge = preds
        result = {
            "pred_node": pred_node, "pred_pos": pred_pos + center,
            "pred_edge": pred_edge, "lig_mask": batch.lig_mask,
            "final_state": {"pos": state["pos"] + center,
                            "node": state["node"], "edge": state["edge"]},
        }
        if frames is not None:
            ids = (lambda x: x) if state["node"].is_floating_point() \
                else (lambda x: x.to(torch.int8))
            result["traj"] = {
                "node": torch.stack([ids(f["node"]) for f in frames]),
                "pos": torch.stack([f["pos"] + center for f in frames]),
                "edge": torch.stack([ids(f["edge"]) for f in frames])}
        return result

    def sample_chunked(self, batch: PhoreGraphBatch, chunk_steps: int,
                       generator: Optional[torch.Generator] = None,
                       offset_init_by_center: bool = False) -> Dict:
        """`sample` with the host waiting for the card every `chunk_steps`
        steps: the same steps, the same outputs bit for bit."""
        if chunk_steps < 1:
            raise ValueError("chunk_steps must be at least 1")
        return self.sample(batch, generator, offset_init_by_center,
                           chunk_steps=chunk_steps)


def sample_lockstep(runs: Sequence) -> list:
    """Drive reverse processes (`Sampler.steps`), given as (device, run)
    pairs, one step of each in turn until all have ended; returns their
    results in order. The kernels of a step are queued on its device
    without a host wait, so the shards of a pool on several cards run at
    once; on one card they interleave."""
    results = [None] * len(runs)
    live = list(range(len(runs)))
    while live:
        for k in list(live):
            dev, run = runs[k]
            ctx = (torch.cuda.device(dev) if torch.device(dev).type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                try:
                    next(run)
                except StopIteration as stop:
                    results[k] = stop.value
                    live.remove(k)
    return results
