"""PhoreGen model orchestrator: schedules, transitions, network, loss.

Counterpart of `phoregen_tpu/models/phoregen.py::PhoreGen`: the three beta
schedules, the position Gaussian transition, the node/edge transitions
(categorical, or with `categorical_space: continuous` Gaussian over the
one-hots scaled by `diff.scaling[1:3]`), the network, and the training
loss (`compute_loss`: the joint position / node / edge / atom-count loss,
masked over padded slots; without `bond_diffusion` no edge term). The
loss is split in two so that a test can inject the perturbation:
`perturb` draws t, the coordinate jitter and the forward noise (from a
`torch.Generator`, or takes them as given), `loss_from_perturbation` runs
the network on it and reduces the losses and metrics.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..constants import MAX_ATOMS, MIN_ATOMS, phore_ex_column
from ..diffusion.categorical import CategoricalTransition
from ..diffusion.gaussian import GaussianTransition
from ..ops import draws
from ..ops.masked import masked_sums
from ..ops.schedules import get_beta_schedule
from .diffusion_model import PhoreDiffNet, apply_net, cast_params
from .layers import dtype_of


def qd_sums(y_true, y_l, y_u, s=160.0, weights=None) -> Dict:
    """The batch sums of the quality-driven interval loss: the graph
    count `n`, the captured widths `mpiw` and their count `k_h` (hard
    counts: sign and relu, as in the JAX package) and the soft capture
    `picp`. y_*: [B, 1]; `weights` ([B, 1] in {0, 1}) excludes graphs."""
    if weights is None:
        weights = torch.ones_like(y_true)
    k_u_h = torch.relu(torch.sign(y_u - y_true))
    k_l_h = torch.relu(torch.sign(y_true - y_l))
    k_s = torch.sigmoid((y_u - y_true) * s) * torch.sigmoid(
        (y_true - y_l) * s)
    k_h = k_u_h * k_l_h
    return {"n": weights.sum(), "mpiw": ((y_u - y_l) * k_h * weights).sum(),
            "k_h": (k_h * weights).sum(), "picp": (k_s * weights).sum()}


def qd_from_sums(sums: Dict, a=0.05, nd=15.0, factor=1.0, epsilon=1e-12):
    """Soft PICP / MPIW loss from `qd_sums` (of one batch, or summed over
    the ranks of a data-parallel step)."""
    n = sums["n"]
    mpiw_c = sums["mpiw"] / (sums["k_h"] + epsilon) * factor
    picp = sums["picp"] / torch.clamp(n, min=1.0)
    return mpiw_c + torch.relu((1 - a) - picp) ** 2 * (n ** 0.5) * nd


def qd_loss(y_true, y_l, y_u, a=0.05, s=160.0, nd=15.0, factor=1.0,
            epsilon=1e-12, weights=None):
    """Quality-driven interval loss (soft PICP / MPIW). y_*: [B, 1].
    `weights` ([B, 1] in {0, 1}) excludes graphs from the means; None keeps
    the unweighted form."""
    return qd_from_sums(qd_sums(y_true, y_l, y_u, s, weights), a, nd,
                        factor, epsilon)


def _graph_sums(per_graph, graph_weights):
    """(numerator, denominator) of a mean over graphs; `graph_weights`
    [B] excludes graphs (the denominator is then floored at 1)."""
    if graph_weights is None:
        return per_graph.sum(), per_graph.new_tensor(
            float(per_graph.shape[0]))
    w = graph_weights.to(torch.float32)
    return (per_graph * w).sum(), w.sum()


def _graph_mean(num, den, weighted: bool):
    return num / torch.clamp(den, min=1.0) if weighted else num / den


def _exact_match(true, pred_logits, mask):
    wrong = (pred_logits.argmax(-1) != true) & mask
    return (~wrong.flatten(1).any(1)).to(torch.float32)


def _element_match(true, pred_logits, mask):
    ok = ((pred_logits.argmax(-1) == true) & mask).to(torch.float32)
    return ok.flatten(1).sum(1) / torch.clamp(
        mask.to(torch.float32).flatten(1).sum(1), min=1.0)


def exact_match_accuracy(true, pred_logits, mask, graph_weights=None):
    """Fraction of graphs whose every valid entry is argmax-correct. mask:
    [B, ...] validity grid; `graph_weights` [B] excludes graphs."""
    return _graph_mean(*_graph_sums(_exact_match(true, pred_logits, mask),
                                    graph_weights), graph_weights is not None)


def element_accuracy(true, pred_logits, mask, graph_weights=None):
    """Per-element argmax accuracy over valid entries (per-graph mean with
    the denominator floored at 1, then batch mean)."""
    return _graph_mean(*_graph_sums(_element_match(true, pred_logits, mask),
                                    graph_weights), graph_weights is not None)


class BatchSums:
    """The sums over the batch that the loss and its metrics divide,
    collected on this process's rows and then, in a data-parallel step,
    summed over the ranks in one call (`sum_over_ranks`, whose backward
    hands each rank the gradient of its own rows): so every rank forms
    the loss of the global batch, the JAX package's means over all valid
    atoms, bonds and graphs, and not a mean of per-rank means."""

    def __init__(self):
        self._sums: Dict[str, torch.Tensor] = {}

    def add(self, name: str, num, den) -> None:
        self._sums[name + "/num"] = num
        self._sums[name + "/den"] = den

    def add_all(self, name: str, sums: Dict) -> None:
        for k, v in sums.items():
            self._sums[f"{name}/{k}"] = v

    def reduce(self, sum_over_ranks=None) -> Dict[str, torch.Tensor]:
        if sum_over_ranks is None:
            return dict(self._sums)
        names = list(self._sums)
        total = sum_over_ranks(torch.stack(
            [self._sums[k].float().reshape(()) for k in names]))
        return dict(zip(names, total.unbind(0)))


def init_params(net: torch.nn.Module, seed: int) -> None:
    """Fresh parameters as the JAX package's flax modules initialise them:
    every kernel (and `tf_ang_w`) LeCun-normal over its fan-in (a normal of
    variance 1/fan_in truncated at two standard deviations; per layer for
    stacked leaves), LayerNorm scales 1, biases 0, and the two atom-count
    heads' output biases +2 and -2. Drawn from a generator seeded with
    `seed` (torch's numbers, not JAX's)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale" or leaf.endswith("ln_scale"):
                p.fill_(1.0)
            elif leaf == "bias" or leaf.endswith("ln_bias"):
                p.fill_({"atom_mlp_2.bias": 2.0,
                         "atom_mlp_1_2.bias": -2.0}.get(name, 0.0))
            else:
                # 0.8796 = std of a unit normal truncated at +-2
                std = (1.0 / p.shape[-2]) ** 0.5 / 0.87962566103423978
                w = torch.empty(p.shape)
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
                p.copy_(w)


class PhoreGen:
    def __init__(self, config):
        self.config = config
        mcfg = config.model
        diff = mcfg.diff
        T = diff.num_timesteps
        self.num_timesteps = T
        self.categorical_space = diff.categorical_space
        if self.categorical_space not in ("discrete", "continuous"):
            raise ValueError(f"categorical_space must be discrete or "
                             f"continuous, got {self.categorical_space!r}")
        self.pos_betas = np.asarray(get_beta_schedule(
            diff.diff_pos.beta_schedule, T, **diff.diff_pos.schedule_kwargs()))
        self.node_betas = np.asarray(get_beta_schedule(
            diff.diff_atom.beta_schedule, T,
            **diff.diff_atom.schedule_kwargs()))
        self.edge_betas = np.asarray(get_beta_schedule(
            diff.diff_bond.beta_schedule, T,
            **diff.diff_bond.schedule_kwargs()))
        self.pos_transition = GaussianTransition(self.pos_betas)
        if self.categorical_space == "discrete":
            self.node_transition = CategoricalTransition(
                self.node_betas, mcfg.num_atom_classes,
                diff.diff_atom.init_prob)
            self.edge_transition = CategoricalTransition(
                self.edge_betas, mcfg.num_bond_classes,
                diff.diff_bond.init_prob)
        else:
            self.node_transition = GaussianTransition(
                self.node_betas, mcfg.num_atom_classes, diff.scaling[1])
            self.edge_transition = GaussianTransition(
                self.edge_betas, mcfg.num_bond_classes, diff.scaling[2])
        self.ex_col = phore_ex_column(config.dataset.data_name)
        self.net = PhoreDiffNet(mcfg, self.ex_col)
        self.loss_weight = tuple(mcfg.loss_weight)

    # ----- time sampling -----
    def sample_time(self, num_graphs: int, generator, device
                    ) -> torch.Tensor:
        """Antithetic: half uniform, half T-1-t (over the whole batch when
        `generator` is a `BatchRows`, then its rows)."""
        gen, total, rows = draws.batch_extent(generator, num_graphs)
        half = total // 2 + 1
        t = torch.randint(0, self.num_timesteps, (half,),
                          generator=gen, device=device)
        t = torch.cat([t, self.num_timesteps - t - 1])[:total]
        return t if rows is None else t[rows]

    # ----- training loss -----
    def perturb(self, batch, generator: Optional[torch.Generator] = None,
                lig_noise_std: float = 0.0, *, t=None, jitter=None,
                pos_noise=None, node_uniform=None, edge_uniform=None,
                node_noise=None, edge_noise=None
                ) -> Dict[str, torch.Tensor]:
        """The random half of a training step: timestep per graph,
        coordinate jitter (`lig_noise_std` > 0) and the forward noise of
        positions, atom types and bond types. Each draw comes from
        `generator` unless given: `t` [B] int, `jitter` and `pos_noise`
        [B,NL,3] standard normal; discrete types: `node_uniform` [B,NL,Ka]
        and `edge_uniform` [B,NL,NL,Kb] in [0,1); continuous types:
        `node_noise` and `edge_noise`, standard normal of those shapes.
        The continuous form holds the scaled one-hots `h_node_0`,
        `h_edge_0` in place of the log-probabilities."""
        dev = batch.lig_pos.device
        lig_pos = batch.lig_pos
        if lig_noise_std > 0:
            if jitter is None:
                jitter = draws.randn(lig_pos.shape, generator, dev)
            lig_pos = lig_pos + lig_noise_std * jitter
        if t is None:
            t = self.sample_time(batch.num_graphs, generator, dev)
        t = t.long()
        out = dict(t=t, lig_pos=lig_pos,
                   pos_pert=self.pos_transition.add_noise(
                       lig_pos, t, generator, pos_noise))
        if self.categorical_space == "continuous":
            out["h_node_pert"], out["h_node_0"] = \
                self.node_transition.add_noise(batch.lig_type, t, generator,
                                               node_noise)
            out["h_edge_pert"], out["h_edge_0"] = \
                self.edge_transition.add_noise(batch.bond_type, t,
                                               generator, edge_noise)
            return out
        (out["h_node_pert"], out["log_node_t"],
         out["log_node_0"]) = self.node_transition.add_noise(
            batch.lig_type, t, generator, node_uniform)
        (out["h_edge_pert"], out["log_edge_t"],
         out["log_edge_0"]) = self.edge_transition.add_noise(
            batch.bond_type, t, generator, edge_uniform)
        return out

    def _categorical_sums(self, trans, pred_logits, log_v0, log_vt, t,
                          mask):
        log_recon = torch.log_softmax(pred_logits, dim=-1)
        post_true = trans.q_v_posterior(log_v0, log_vt, t, v0_prob=True)
        post_pred = trans.q_v_posterior(log_recon, log_vt, t, v0_prob=True)
        return masked_sums(trans.compute_v_Lt(post_true, post_pred, log_v0,
                                              t), mask)

    def loss_from_perturbation(self, batch, pert, graph_mask=None,
                               compute_dtype: str = "float32",
                               sum_over_ranks=None
                               ) -> Tuple[torch.Tensor, Dict]:
        """Network on the perturbed state, then the joint loss and the
        metrics. `graph_mask` ([B] bool) excludes graphs from every
        reduction (the cycled duplicates of a validation tail batch).

        `compute_dtype` 'bfloat16' runs the network in bf16 (mixed
        precision, as the JAX package's `compute_loss`): the float32 master
        parameters are cast by a differentiable copy (`cast_params`), so
        their gradients come back float32; the features go in as bf16,
        positions stay float32, and the predictions are widened to float32
        before the losses.

        `sum_over_ranks` (`parallel/group.py`), in a data-parallel step
        where `batch` is this rank's rows of the global batch, sums every
        numerator and denominator over the ranks (`BatchSums`): the loss
        and the metrics are then those of the global batch on every rank."""
        mcfg = self.config.model
        t, lig_pos = pert["t"], pert["lig_pos"]
        cdt = dtype_of(compute_dtype)
        preds = apply_net(
            self.net, cast_params(self.net, cdt),
            pert["h_node_pert"].to(cdt), pert["pos_pert"], batch.lig_mask,
            pert["h_edge_pert"].to(cdt), t, batch.phore_x.to(cdt),
            batch.phore_pos, batch.phore_norm, batch.phore_mask)
        pred_node, pred_pos, pred_edge = (
            None if p is None else p.float() for p in preds[:3])
        pred_count = tuple(c.float() for c in preds[3])
        lmask, emask, gw = batch.lig_mask, batch.bond_mask, None
        if graph_mask is not None:
            gm = graph_mask.to(torch.bool)
            lmask = lmask & gm[:, None]
            emask = emask & gm[:, None, None]
            gw = gm.to(torch.float32)
        sums = BatchSums()
        # position MSE over valid atoms (summed over xyz, per valid atom)
        sums.add("pos", *masked_sums((pred_pos - lig_pos) ** 2,
                                     lmask[..., None]))
        if self.categorical_space == "discrete":
            sums.add("node", *self._categorical_sums(
                self.node_transition, pred_node, pert["log_node_0"],
                pert["log_node_t"], t, lmask))
            if mcfg.bond_diffusion:
                sums.add("edge", *self._categorical_sums(
                    self.edge_transition, pred_edge, pert["log_edge_0"],
                    pert["log_edge_t"], t, emask))
        else:
            # the relaxed one-hots: MSE against the scaled one-hots x 30
            sums.add("node", *masked_sums((pred_node - pert["h_node_0"]) ** 2,
                                          lmask[..., None]))
            if mcfg.bond_diffusion:
                sums.add("edge", *masked_sums(
                    (pred_edge - pert["h_edge_0"]) ** 2, emask[..., None]))
        if mcfg.bond_len_loss:  # over true bonds
            bmask = emask & (batch.bond_type > 0)
            pair_dist = lambda p: torch.sqrt(
                ((p[:, None] - p[:, :, None]) ** 2).sum(-1) + 1e-12)
            sums.add("len", *masked_sums(
                (pair_dist(pred_pos) - pair_dist(lig_pos)) ** 2, bmask))
        # atom-count interval loss, count normalized to [0, 1]
        true_count = batch.atom_counts.to(torch.float32)
        norm_count = ((true_count - MIN_ATOMS) / (MAX_ATOMS - MIN_ATOMS)
                      )[:, None]
        sums.add_all("count", qd_sums(
            norm_count, *pred_count, s=160.0,
            weights=None if gw is None else gw[:, None]))
        hit = ((norm_count >= pred_count[0]) & (norm_count <= pred_count[1])
               ).to(torch.float32)[:, 0]
        sums.add("count_hit", *_graph_sums(hit, gw))
        sums.add("node_acc", *_graph_sums(
            _exact_match(batch.lig_type, pred_node, lmask), gw))
        sums.add("node_elem_acc", *_graph_sums(
            _element_match(batch.lig_type, pred_node, lmask), gw))
        if mcfg.bond_diffusion:
            sums.add("edge_acc", *_graph_sums(
                _exact_match(batch.bond_type, pred_edge, emask), gw))
            sums.add("edge_elem_acc", *_graph_sums(
                _element_match(batch.bond_type, pred_edge, emask), gw))
        g = sums.reduce(sum_over_ranks)
        mean = lambda k: g[k + "/num"] / torch.clamp(g[k + "/den"],
                                                     min=1e-12)
        graph_mean = lambda k: _graph_mean(g[k + "/num"], g[k + "/den"],
                                           gw is not None)
        out = {}
        loss_pos = mean("pos") * self.loss_weight[0]
        if self.categorical_space == "discrete":
            loss_node = mean("node") * self.loss_weight[1]
            loss_edge = (mean("edge") * self.loss_weight[2]
                         if mcfg.bond_diffusion else 0.0)
        else:
            loss_node = mean("node") * 30.0
            loss_edge = mean("edge") * 30.0 if mcfg.bond_diffusion else 0.0
        loss_len = 0.0
        if mcfg.bond_len_loss:
            loss_len = out["loss_len"] = mean("len")
        loss_count = qd_from_sums(
            {k: g["count/" + k] for k in ("n", "mpiw", "k_h", "picp")},
            nd=15.0, factor=mcfg.count_factor)
        loss = loss_pos + loss_node + loss_edge + loss_count + loss_len
        out.update(
            loss=loss, loss_pos=loss_pos, loss_node=loss_node,
            loss_count=loss_count, count_hit=graph_mean("count_hit"),
            node_acc=graph_mean("node_acc"),
            node_elem_acc=graph_mean("node_elem_acc"))
        if mcfg.bond_diffusion:
            out.update(loss_edge=loss_edge, edge_acc=graph_mean("edge_acc"),
                       edge_elem_acc=graph_mean("edge_elem_acc"))
        return loss, out

    def compute_loss(self, batch, generator=None,
                     lig_noise_std: float = 0.0,
                     compute_dtype: str = "float32", graph_mask=None,
                     sum_over_ranks=None, **draws
                     ) -> Tuple[torch.Tensor, Dict]:
        """Joint pos/node/edge/count loss of one batch on the network's
        current parameters; `draws` are `perturb`'s injected draws;
        `compute_dtype` (`train.dtype`) the network's dtype and
        `sum_over_ranks` the data-parallel reduction (see
        `loss_from_perturbation`)."""
        dtype_of(compute_dtype)
        pert = self.perturb(batch, generator, lig_noise_std, **draws)
        return self.loss_from_perturbation(batch, pert, graph_mask,
                                           compute_dtype, sum_over_ranks)


def load_release_model(prefix: str, device="cuda", config=None,
                       fused_stack=None, triplet_knn=None,
                       use_pallas_triplet=None, use_ema: bool = False,
                       fused_block_dtype=None, compute_dtype=None):
    """Build `PhoreGen` from `<prefix>.json` (or `config`) with the weights
    of `<prefix>.msgpack`, on `device`. `fused_stack`, `triplet_knn` and
    `use_pallas_triplet` override the denoiser's configuration; None keeps
    the checkpoint's own value (the release checkpoints say fused_stack
    'none', the per-layer module path; the fused stack takes the same
    parameters); `fused_block_dtype` and `compute_dtype` likewise
    (`denoiser.fused_block_dtype`, `model.compute_dtype`). `use_ema` takes
    a training checkpoint's EMA shadow (`utils/checkpoint.py::load_release`).
    Returns (pg, meta)."""
    from ..config import config_from_dict
    from ..utils.checkpoint import from_jax_params, load_release

    tree, meta = load_release(prefix, use_ema=use_ema)
    cfg = config if config is not None else config_from_dict(meta["config"])
    dcfg = cfg.model.denoiser
    if fused_stack is not None:
        dcfg.fused_stack = fused_stack
    if triplet_knn is not None:
        dcfg.triplet_knn = triplet_knn
    if use_pallas_triplet is not None:
        dcfg.use_pallas_triplet = use_pallas_triplet
    if fused_block_dtype is not None:
        dcfg.fused_block_dtype = fused_block_dtype
    if compute_dtype is not None:
        cfg.model.compute_dtype = compute_dtype
    return model_from_state(cfg, from_jax_params(tree), device), meta


def model_from_state(config, state_dict, device="cuda") -> PhoreGen:
    """`PhoreGen(config)` with the weights `state_dict` (the port's names,
    e.g. `from_jax_params` of a flax-layout tree; every parameter must be
    given and used), in eval mode on `device`."""
    pg = PhoreGen(config)
    pg.net.load_state_dict(state_dict, strict=True)
    pg.net.to(torch.device(device)).eval()
    return pg


def load_reference_model(path: str, config, device="cuda"):
    """`PhoreGen(config)` with the weights of a reference `.pt` checkpoint
    (`utils/torch_import.py`; `config` must say `denoiser.triplet_mode:
    dense`). Returns (pg, meta) with the checkpoint's `epoch`."""
    from ..utils.checkpoint import from_jax_params
    from ..utils.torch_import import load_reference_checkpoint

    tree, meta = load_reference_checkpoint(path, config)
    return model_from_state(config, from_jax_params(tree), device), meta
