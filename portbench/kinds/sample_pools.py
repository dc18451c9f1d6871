"""Sampling pools back to back, as the sampling pipeline builds them: the
general driver of every traffic mix of kind `sample_pools`.

A traffic file gives the phore, the pool's batch, the count rule, the
guidance, and how often steps are kept for the check. Each pool, as
`GenerationPipeline.sample_pool` builds one: the count interval from the
network's count head (rounded and clamped as the pipeline does), the
per-graph atom counts, the ligand bucket, `replicate_phore`, then
`Sampler.prepare` and `Sampler.init_state`, then the reverse steps, one
`Sampler.step` a step. The harness makes each step's uniforms and normals
itself from the run's seed and hands them to the step (`draws`), so that
the reference can follow the same step; the pipeline's own sampler draws
the same numbers from its generator.

The counts are the same multiset for every seed: the recipe's normal
distribution over the interval, taken at the quantiles (k + 0.5) / B and
rounded, in an order drawn from the seed; so every seed asks for the same
work, and every pool lands in the same bucket.

Correct: after the window, the kept steps (one in `check_every`; of
them the latest in its schedule and up to `check_max` - 1 drawn from the
seed) and their pools' set-up are followed by the plain reference from the
program's own state (`check_pools`).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from .. import trace, workcount
from ..harness import device_record, judge, timed_window


def pool_counts(lower: int, upper: int, traffic: Dict, rng) -> np.ndarray:
    """The pool's per-graph atom counts (see the module's docstring)."""
    B = traffic["batch"]
    rule = traffic["counts"]
    if rule["mode"] != "normal":
        raise ValueError(f"count mode {rule['mode']!r}")
    mid = (lower + upper) / 2.0
    std = (upper - lower) / rule["scale"]
    nd = statistics.NormalDist()
    x = [mid + std * nd.inv_cdf((k + 0.5) / B) for k in range(B)]
    c = np.clip(np.round(x), lower, upper).astype(np.int32)
    return c[rng.permutation(B)]


def _clone(d):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


class Pools:
    """The program's sampler driven pool after pool."""

    def __init__(self, pg, cell, device, seed: int):
        from phoregen_tpu_torch.data.phore import parse_phore_file
        from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
        from phoregen_tpu_torch.sample.sampler import GuidanceOpt

        tr = cell.traffic
        self.tr = tr
        self.pg = pg
        self.device = torch.device(device)
        self.seed = seed
        self.guidance = tr["guidance"]
        self.pipe = GenerationPipeline(
            pg, guidance=[GuidanceOpt(**g) for g in self.guidance],
            sample_nodes_mode=tr["counts"]["mode"],
            normal_scale=tr["counts"]["scale"], batch_size=tr["batch"],
            seed=seed, device=device)
        self.sampler = self.pipe.sampler
        self.S = len(self.sampler.schedule()[0])
        self.phore_sample = self.pipe.prepare_phore(
            parse_phore_file(tr["phore"]))
        self.n_phore = int(self.phore_sample["phore_mask"].sum())
        self.rng = np.random.default_rng([seed, 1])
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.pools: List[Dict] = []
        self.i = self.S          # no pool open
        self.keep = False        # keep the pools' set-up and chosen steps

    def new_pool(self):
        from phoregen_tpu_torch.constants import MAX_ATOMS, MIN_ATOMS
        from phoregen_tpu_torch.data.batching import (collate, pick_bucket,
                                                      replicate_phore)
        one = collate([self.phore_sample]).to(self.device)
        with torch.no_grad():
            lo_f, up_f = self.pg.net.count_interval(
                one.phore_x, one.phore_pos, one.phore_norm, one.phore_mask)
        den = lambda c: int(torch.round(
            c[0, 0] * (MAX_ATOMS - MIN_ATOMS) + MIN_ATOMS))
        lo = max(MIN_ATOMS, min(den(lo_f), MAX_ATOMS))
        up = max(lo, min(den(up_f), MAX_ATOMS))
        counts = pool_counts(lo, up, self.tr, self.rng)
        n_lig = pick_bucket(int(counts.max()),
                            self.pg.config.dataset.ligand_buckets)
        self.batch = replicate_phore(self.phore_sample, len(counts), counts,
                                     n_lig).to(self.device)
        self.inv = self.sampler.prepare(self.batch)
        self.state = self.sampler.init_state(self.batch, self.gen)
        self.i = 0
        pool = {"counts": counts, "n_lig": n_lig, "interval": (lo, up),
                "steps": []}
        if self.keep:
            pool.update(count_f=(lo_f.clone(), up_f.clone()),
                        h_phore=self.inv["h_phore"].clone())
        self.pools.append(pool)

    def draws(self):
        B, NL = self.batch.lig_mask.shape
        mcfg = self.pg.config.model
        g, dev = self.gen, self.device
        return {"node_u": torch.rand((B, NL, mcfg.num_atom_classes),
                                     generator=g, device=dev),
                "edge_u": torch.rand((B, NL, NL, mcfg.num_bond_classes),
                                     generator=g, device=dev),
                "pos_noise": torch.randn((B, NL, 3), generator=g,
                                         device=dev)}

    def step(self, keep_this: bool = False):
        """One reverse step (opening a new pool first when the last one
        has ended)."""
        if self.i >= self.S:
            self.new_pool()
        d = self.draws()
        state_in = self.state
        self.state, preds = self.sampler.step(
            self.state, self.i, self.batch, self.inv, self.i == self.S - 1,
            None, draws=d)
        if keep_this:
            self.pools[-1]["steps"].append({
                "i": self.i, "state_in": _clone(state_in), "draws": d,
                "preds": tuple(p.clone() for p in preds),
                "state_out": _clone(self.state)})
        self.i += 1

    def free(self):
        """Drop the program's live pool (the kept copies stay)."""
        self.batch = self.inv = self.state = None


def load_program(cell, device):
    """The program's model as the configuration file states it (the same
    call the sampling CLI's `load_model` makes), and a check that the
    configuration as run is the file's."""
    from phoregen_tpu_torch.config import config_from_dict
    from phoregen_tpu_torch.models.phoregen import load_release_model
    conf = cell.config
    pg, _ = load_release_model(conf["checkpoint"], device=device,
                               config=config_from_dict(conf["config"]))
    as_run = pg.config.to_dict()
    diff = [f"{sec}.{k}" for sec in ("model", "dataset")
            for k, v in conf["config"][sec].items() if as_run[sec][k] != v]
    if diff:
        raise SystemExit(f"[E] the program runs another configuration than "
                         f"{cell.config_entry['file']} states: {diff}")
    return pg


def warm(pg, cell, device, seed: int) -> Pools:
    """The pools of one run, warmed up: a pool's set-up, two steps and
    its final step, so that every shape of the window has run once; the
    window then opens on a new pool."""
    pools = Pools(pg, cell, device, seed)
    pools.new_pool()
    pools.step()
    pools.step()
    pools.i = pools.S - 1
    pools.step()
    if pools.device.type == "cuda":
        torch.cuda.synchronize()
    pools.pools.clear()
    pools.keep = True
    return pools


def window(pools, seconds: float, traced: bool, steps_override: int = 0
           ) -> Dict:
    """Pools back to back for `seconds` (`harness.timed_window`), keeping
    one step in `check_every` for the check; traced, CUDA events after
    every step for the step intervals."""
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


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        t_origin: float, steps_override: int = 0) -> Dict:
    """One run of a sampling cell: set-up, warm-up, the window, the
    check. `t_origin` is the process's start on the `time.perf_counter`
    clock; `steps_override` (tests) caps the window at that many steps in
    place of `seconds`."""
    pools = warm(load_program(cell, device), cell, device, seed)
    setup_s = time.perf_counter() - t_origin
    out = window(pools, seconds, traced, steps_override)
    out["e2e"] = {"sample_mol_per_s": out["sample_mol_per_s"],
                  "setup_s": setup_s}
    out["device"] = device_record(device, 1)
    pools.free()
    values, n_checked = check_pools(pools, cell, device)
    out["correct"], out["checks"] = judge(values, cell.limits)
    out["failed"] = 0 if out["correct"] else n_checked
    out["values"] = values
    return out


def _record(pools, events, prof_steps, prof) -> Dict:
    """What the per-layer metrics of a sampling cell read."""
    import json
    import os
    rec = {"kind": "sample"}
    lo, hi = prof_steps
    # step intervals from the CUDA events, leaving out those that touch
    # the traced steps (the profiler's own cost)
    iv = [e1.elapsed_time(e2) for (n1, e1), (n2, e2) in zip(events, events[1:])
          if lo is None or not (n2 > lo and n1 <= hi + 1)]
    rec["step_ms"] = iv
    if prof is None:
        return rec
    dev, host = trace.events(prof)
    rec["dev"], rec["host"] = dev, host
    rec["traced_steps"] = hi - lo
    pool = pools.pools[-1]
    cfg = pools.pg.config.to_dict()
    dcfg = cfg["model"]["denoiser"]
    NP = pools.phore_sample["phore_x"].shape[0]
    d = workcount.dims_for(dcfg, NP, pool["n_lig"])
    B = len(pool["counts"])
    slots = workcount.slots(pool["counts"], [pools.n_phore] * B, d)
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "peaks.json")) as f:
        peaks = json.load(f)
    rec["peaks"] = peaks
    rec["ops_per_step"] = workcount.network_ops(
        d, slots, dcfg["num_layers"] * dcfg["num_blocks"],
        cfg["model"]["num_atom_classes"], cfg["model"]["num_bond_classes"],
        cfg["model"]["diff"]["time_dim"], [pools.n_phore] * B, pools.S)
    rec["stack_roofline_s_per_step"] = workcount.stack_roofline_s(
        dcfg["fused_stack"], dcfg["fused_block_dtype"], d, slots,
        dcfg["num_layers"] * dcfg["num_blocks"], peaks)
    return rec


# ----- the check ---------------------------------------------------------

def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


def compare_step(prog: Dict, ref: Dict, lig_mask, draws: Dict
                 ) -> Dict[str, float]:
    """The numbers of one step, on the slots that hold atoms (and pairs
    of two atoms): the network's predictions (largest error over the
    tensor's largest value), the posteriors' probabilities, the new
    positions (Angstrom), and the Gumbel-max choices: how many differ from
    the argmax of the run's own log posterior plus the Gumbel noise of the
    step's uniforms (an exact comparison)."""
    from ..reference.masked import LOG_EPS
    B, NL = lig_mask.shape
    eye = torch.eye(NL, dtype=torch.bool, device=lig_mask.device)
    pair = lig_mask[:, :, None] & lig_mask[:, None, :] & ~eye
    atom = lig_mask
    pn, pp, pe = (p.float() for p in prog["preds"])
    so = prog["state_out"]
    net = max(_rel(pn[atom], ref["pred_node"][atom]),
              _rel(pp[atom], ref["pred_pos"][atom]),
              _rel(pe[pair], ref["pred_edge"][pair]))
    post = max(float((so["log_node"].exp() - ref["log_node"].exp())[atom]
                     .abs().max()),
               float((so["log_edge"].exp() - ref["log_edge"].exp())[pair]
                     .abs().max()))
    gumbel = lambda u: -torch.log(-torch.log(u + LOG_EPS) + LOG_EPS)
    wrong = sum(int(((so[k] + gumbel(draws[u])).argmax(-1)
                     != so[c].long())[m].sum())
                for k, u, c, m in (("log_node", "node_u", "node", atom),
                                   ("log_edge", "edge_u", "edge", pair)))
    pos = float((so["pos"] - ref["pos"])[atom].abs().max())
    return {"net_err": net, "post_err": post, "choice_mismatch": wrong,
            "pos_err": pos}


def reference_steps(pools, cell, device, ref=None):
    """Yield (pool, kept step, the reference's step from the program's
    state) for the kept steps chosen for the check, and the pool set-up
    numbers as a step-less (pool, None, numbers) item."""
    from ..reference.sampling import RefModel, phore_arrays, pool_batch
    tr = cell.traffic
    conf = cell.config
    if ref is None:
        ref = RefModel(conf["config"], conf["checkpoint"], device)
    phore = phore_arrays(tr["phore"], conf["config"]["dataset"]["data_name"],
                         conf["config"]["dataset"]["max_phore"], pools.seed)
    kept = [(p, s) for p in pools.pools for s in p["steps"]]
    chosen = []
    if kept:
        # the kept step latest in its schedule (where the network weighs
        # most in the posteriors), and others drawn from the seed
        late = max(range(len(kept)), key=lambda k: kept[k][1]["i"])
        rest = [k for k in range(len(kept)) if k != late]
        rng = np.random.default_rng([pools.seed, 3])
        pick = rng.choice(len(rest), size=min(tr["check_max"] - 1,
                                              len(rest)), replace=False)
        chosen = [kept[k] for k in sorted([late] + [rest[j] for j in pick])]
    for p in pools.pools:
        if "count_f" not in p:
            continue
        b = pool_batch(phore, p["counts"], p["n_lig"], device)
        lo, up = ref.count_interval({k: v[:1] for k, v in b.items()})
        h = ref.embed_phore(b)
        pm = b["phore_mask"]
        setup = {"net_err": max(_rel(p["count_f"][0], lo),
                                _rel(p["count_f"][1], up),
                                _rel(p["h_phore"].float()[pm], h[pm]))}
        yield p, None, setup
        for pp, s in chosen:
            if pp is not p:
                continue
            r = ref.step(s["state_in"], s["i"], b, h, s["draws"],
                         tr["guidance"],
                         edge_for_energy=s["state_out"]["edge"])
            yield p, s, r
            del r


def check_pools(pools, cell, device, ref=None):
    """({number: the largest over the checked steps and pool set-ups},
    steps checked), the reference in float32 with TF32 off."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    values: Dict[str, float] = {}
    n = 0
    for p, s, r in reference_steps(pools, cell, device, ref):
        nums = r if s is None else compare_step(
            s, r, torch.as_tensor(
                np.arange(p["n_lig"])[None] < p["counts"][:, None],
                device=device), s["draws"])
        n += s is not None
        for k, v in nums.items():
            values[k] = max(values.get(k, 0.0), v)
    if n == 0:
        return {}, 0
    return values, n
