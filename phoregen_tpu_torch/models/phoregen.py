"""PhoreGen model orchestrator: schedules, transitions and the network.

Counterpart of `phoregen_tpu/models/phoregen.py::PhoreGen`, sampling half:
the three beta schedules, the position Gaussian transition, the node/edge
categorical transitions and the network. The training loss is a later
slice of the port.
"""
from __future__ import annotations

import numpy as np

from ..constants import phore_ex_column
from ..diffusion.categorical import CategoricalTransition
from ..diffusion.gaussian import GaussianTransition
from ..ops.schedules import get_beta_schedule
from .diffusion_model import PhoreDiffNet


class PhoreGen:
    def __init__(self, config):
        self.config = config
        mcfg = config.model
        diff = mcfg.diff
        T = diff.num_timesteps
        self.num_timesteps = T
        self.categorical_space = diff.categorical_space
        if self.categorical_space != "discrete":
            raise NotImplementedError(
                "categorical_space='continuous' is not ported yet")
        self.pos_betas = np.asarray(get_beta_schedule(
            diff.diff_pos.beta_schedule, T, **diff.diff_pos.schedule_kwargs()))
        self.node_betas = np.asarray(get_beta_schedule(
            diff.diff_atom.beta_schedule, T,
            **diff.diff_atom.schedule_kwargs()))
        self.edge_betas = np.asarray(get_beta_schedule(
            diff.diff_bond.beta_schedule, T,
            **diff.diff_bond.schedule_kwargs()))
        self.pos_transition = GaussianTransition(self.pos_betas)
        self.node_transition = CategoricalTransition(
            self.node_betas, mcfg.num_atom_classes, diff.diff_atom.init_prob)
        self.edge_transition = CategoricalTransition(
            self.edge_betas, mcfg.num_bond_classes, diff.diff_bond.init_prob)
        self.ex_col = phore_ex_column(config.dataset.data_name)
        self.net = PhoreDiffNet(mcfg, self.ex_col)


def load_release_model(prefix: str, device="cuda", config=None,
                       fused_stack: str = "pallas"):
    """Build `PhoreGen` from `<prefix>.json` (or `config`) with the weights
    of `<prefix>.msgpack`, on `device`. The release checkpoints were saved
    with fused_stack 'none'; the fused stack takes the same parameters, and
    `fused_stack` selects the path the port runs. Returns (pg, meta)."""
    import torch

    from ..config import config_from_dict
    from ..utils.checkpoint import from_jax_params, load_release

    tree, meta = load_release(prefix)
    cfg = config if config is not None else config_from_dict(meta["config"])
    if fused_stack:
        cfg.model.denoiser.fused_stack = fused_stack
    pg = PhoreGen(cfg)
    pg.net.load_state_dict(from_jax_params(tree, cfg), strict=True)
    pg.net.to(torch.device(device)).eval()
    return pg, meta
