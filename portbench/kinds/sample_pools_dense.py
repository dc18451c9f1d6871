"""Sampling pools back to back through a network with the dense triplet
bond update (PhoreGen's published `BondUpdateLayer`): how traffic of kind
`sample_pools_dense` is run.

The run is `sample_pools`' own (its `Pools`, `warm`, window and
`check_pools`), with two differences:

- the check's reference puts the published layer in its upstream form
  (`reference/triplet_upstream.py`: graph by graph over the explicit list
  of triplets, no padded grid) in place of the reference network's bond
  update, so that the comparison does not share the program's form;
- a traced run's record adds the dense network's operations a step
  (`ops_per_step`, in place of the factorized count, so that
  `mfu.sample` reads it right), the dense layers' least time a step
  (`triplet_roofline_s_per_step`, `workcount_dense.roofline_s`) and the
  device's busy ms a step inside each program span (`span_dev_ms`, from
  the profiler's device-side ranges, `devspans.py`).

`readings` gives the rows of `portbench/control_dense.py`.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np

from .. import devspans, workcount_dense
from ..harness import device_record, judge, timed_window
from . import sample_pools as sp


def reference(cell, device):
    """The plain reference of the cell's network, its bond update the
    published layer in its upstream form."""
    from ..reference.sampling import RefModel
    from ..reference.triplet_upstream import BondUpdateUpstream
    ref = RefModel(cell.config["config"], cell.config["checkpoint"], device)
    dcfg = ref.cfg.model.denoiser
    ref.net.denoiser.bond_update = BondUpdateUpstream(
        hidden_dim=dcfg.hidden_dim, n_heads=dcfg.n_heads, norm=dcfg.norm,
        act_fn=dcfg.act_fn, include_h_node=dcfg.h_node_in_bond_net)
    return ref


def _window(pools, seconds: float, traced: bool, steps_override: int = 0
            ) -> Dict:
    """`sample_pools.window`, with the dense record."""
    tr = pools.tr
    every = tr["check_every"]
    offset = int(np.random.default_rng([pools.seed, 2]).integers(every))
    w = timed_window(lambda n: pools.step(keep_this=(n % every == offset)),
                     seconds, traced, tr["trace_steps"],
                     pools.device.type == "cuda", steps_override,
                     events=True)
    out = {"window_s": w["window_s"], "steps": w["steps"],
           "attempted": w["steps"],
           "sample_mol_per_s": tr["batch"] * w["steps"] / pools.S
           / w["window_s"]}
    if traced:
        out["record"] = _record(pools, w["events"], w["prof_steps"],
                                w["prof"])
    return out


def _record(pools, events, prof_steps, prof) -> Dict:
    rec = sp._record(pools, events, prof_steps, prof)
    if prof is None:
        return rec
    pool = pools.pools[-1]
    cfg = pools.pg.config.to_dict()
    NP = pools.phore_sample["phore_x"].shape[0]
    B = len(pool["counts"])
    rec["ops_per_step"] = workcount_dense.network_ops(
        cfg, NP, pool["n_lig"], pool["counts"], [pools.n_phore] * B,
        pools.S)
    rec["triplet_roofline_s_per_step"] = workcount_dense.roofline_s(
        cfg, pool["counts"], rec["peaks"])
    rec["span_dev_ms"] = devspans.per_step_ms(
        rec["dev"], devspans.ranges(prof), rec["traced_steps"])
    return rec


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        t_origin: float, steps_override: int = 0) -> Dict:
    """One run of the cell: set-up, warm-up, the window, the check
    (`sample_pools.run`'s, with this kind's record and reference)."""
    pools = sp.warm(sp.load_program(cell, device), cell, device, seed)
    setup_s = time.perf_counter() - t_origin
    out = _window(pools, seconds, traced, steps_override)
    out["e2e"] = {"sample_mol_per_s": out["sample_mol_per_s"],
                  "setup_s": setup_s}
    out["device"] = device_record(device, 1)
    pools.free()
    values, n_checked = sp.check_pools(pools, cell, device,
                                       reference(cell, device))
    out["correct"], out["checks"] = judge(values, cell.limits)
    out["failed"] = 0 if out["correct"] else n_checked
    out["values"] = values
    return out


def readings(cell, seeds, seconds: float, device: str, bits: int,
             steps_override: int = 0, with_control: bool = True):
    """Rows of the program's check numbers (and, with `with_control`, the
    control's: the reference at `bits` mantissa bits in the program's
    place) on each seed, the program loaded once (`portbench.control`'s
    sampling rows, with this kind's reference)."""
    from ..control import sample_control
    pg = sp.load_program(cell, device)
    ref = None
    for seed in seeds:
        pools = sp.warm(pg, cell, device, seed)
        w = _window(pools, seconds, False, steps_override)
        pools.free()
        if ref is None:
            ref = reference(cell, device)
        row = {"seed": seed, "steps": w["steps"],
               "sample_mol_per_s": w["sample_mol_per_s"],
               "program": sp.check_pools(pools, cell, device, ref)[0]}
        if with_control:
            row["control"] = sample_control(pools, cell, device, ref, bits)
        yield row

