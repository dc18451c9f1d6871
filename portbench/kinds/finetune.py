"""Fine-tuning on a corpus made from the seed: the general driver of every
traffic mix of kind `finetune`.

Set-up builds one `Run` of the program (`train/loop.py`) with the
configuration file's configuration and the release weights (the EMA
shadow set to them), a corpus of `corpus.n` samples from the benchmark's
frozen copy of the `mixed` generator (`portbench/corpus.py`), and the
program's `PhoreDataLoader` over it, cycled by epochs as
`Run.run_on_epoch` does. Every step: the loader's next batch and its
`.to(device)` (the `data` span), the step's draws made by the harness
from the seed (the step time per graph, the coordinate jitter, the
position noise and the uniforms of the type noising, as `PhoreGen.perturb`
takes them), and `Run.train_step`. The first `check_steps` steps run in
set-up through the same call and feed; the same objects then run the
window.

Correct: the plain reference (`reference/training.py`) rebuilds the first
steps' batches from the corpus, follows them from the release weights and
compares each step's loss, the first step's gradient as the optimizer got
it (from Adam's first moment after one step) and the parameters' change
after the first steps, by the worst leaf.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import trace, workcount
from ..harness import device_record, judge, timed_window


# the loss's terms, as the program's train step reports them
TERMS = ("loss_pos", "loss_node", "loss_edge", "loss_count")


class Trainer:
    """The program's run, its loader and the step loop."""

    def __init__(self, cell, device, seed: int):
        from phoregen_tpu_torch.config import config_from_dict
        from phoregen_tpu_torch.data.loader import PhoreDataLoader
        from phoregen_tpu_torch.train.checkpoint import load_params_only
        from phoregen_tpu_torch.train.loop import Run

        from ..corpus import mixed_corpus
        conf = cell.config
        tr = cell.traffic
        self.tr = tr
        self.device = torch.device(device)
        self.seed = seed
        cfg = config_from_dict(conf["config"])
        self.cfg = cfg
        self.run_dir = tempfile.mkdtemp(prefix="portbench_run_")
        self.run = Run(cfg, run_dir=self.run_dir, device=device)
        self.state = self.run.init_state()
        load_params_only(conf["checkpoint"], self.state.net)
        for n, p in self.state.net.named_parameters():
            self.state.ema_params[n].copy_(p.detach())
        c = tr["corpus"]
        ds = cfg.dataset
        self.corpus = mixed_corpus(seed, c["n"], ds.data_name,
                                   max_phore=ds.max_phore,
                                   max_atoms=ds.max_atom,
                                   real_frac=ds.real_frac,
                                   size_mean=c["size_mean"],
                                   size_std=c["size_std"])
        self.loader = PhoreDataLoader(self.corpus, cfg, cfg.train.batch_size,
                                      shuffle=True, seed=seed, augment=True)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.T = cfg.model.diff.num_timesteps
        self.epoch = 0
        self._it = None
        self.data_s: List[float] = []
        self.masks: List = []

    def next_batch(self):
        """The loader's next batch on the device (a new epoch when one
        ends): (host batch, device batch, step seed)."""
        from phoregen_tpu_torch.train.loop import mix_step_seed
        t0 = time.perf_counter()
        while True:
            if self._it is None:
                self.loader.set_epoch(self.epoch)
                self._it = enumerate(self.loader.iter_with_sizes())
            try:
                idx, (host, _) = next(self._it)
                break
            except StopIteration:
                self._it = None
                self.epoch += 1
        dev = host.to(self.device)
        self.data_s.append(time.perf_counter() - t0)
        return host, dev, mix_step_seed(self.cfg.train.seed, self.epoch,
                                        "train", idx)

    def draws(self, B: int, NL: int) -> Dict[str, torch.Tensor]:
        """One step's draws (the antithetic time steps as `perturb` draws
        them: half uniform, half mirrored)."""
        g, dev = self.gen, self.device
        mcfg = self.cfg.model
        half = B // 2 + 1
        t = torch.randint(0, self.T, (half,), generator=g, device=dev)
        t = torch.cat([t, self.T - t - 1])[:B]
        return {"t": t,
                "jitter": torch.randn((B, NL, 3), generator=g, device=dev),
                "pos_noise": torch.randn((B, NL, 3), generator=g,
                                         device=dev),
                "node_uniform": torch.rand((B, NL, mcfg.num_atom_classes),
                                           generator=g, device=dev),
                "edge_uniform": torch.rand(
                    (B, NL, NL, mcfg.num_bond_classes), generator=g,
                    device=dev)}

    def step(self):
        host, batch, seed = self.next_batch()
        B, NL = host.lig_mask.shape
        d = self.draws(B, NL)
        m = self.run.train_step(self.state, seed, batch, **d)
        self.masks.append((host.lig_mask.sum(1), host.phore_mask.sum(1),
                           NL, host.phore_mask.shape[1]))
        return host, d, m

    def close(self):
        shutil.rmtree(self.run_dir, ignore_errors=True)


def first_steps(tn: Trainer, n: int) -> Dict:
    """The first `n` steps, with what the check compares: each step's
    loss, the first gradient as Adam got it (its first moment after one
    step over 1 - beta1) and the parameters after the n steps."""
    opt = tn.state.optimizer
    names = {p: name for name, p in tn.state.net.named_parameters()}
    rec = {"hosts": [], "draws": [], "loss": []}
    for k in range(n):
        host, d, m = tn.step()
        rec["hosts"].append(host)
        rec["draws"].append(d)
        rec["loss"].append(m["loss"].detach().clone())
        rec.setdefault("terms", []).append(
            {k: m[k].detach().clone() for k in TERMS if k in m})
        if k == 0:
            b1 = opt.param_groups[0]["betas"][0]
            rec["grad"] = {names[p]: s["exp_avg"].clone() / (1 - b1)
                           for p, s in opt.state.items()}
    rec["params"] = {name: p.detach().clone()
                     for name, p in tn.state.net.named_parameters()}
    rec["trained"] = [names[p] for g in opt.param_groups
                      for p in g["params"]]
    return rec


def run(cell, seed: int, seconds: float, traced: bool, device: str,
        t_origin: float, steps_override: int = 0) -> Dict:
    tr = cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tn = Trainer(cell, device, seed)
    try:
        first = first_steps(tn, tr["check_steps"])
        sync()
        setup_s = time.perf_counter() - t_origin
        tn.data_s.clear()
        tn.masks.clear()
        w = timed_window(lambda n: tn.step(), seconds, traced,
                         tr["trace_steps"], cuda, steps_override)
        n, window_s = w["steps"], w["window_s"]
        B = tn.cfg.train.batch_size
        out = {"setup_s": setup_s, "window_s": window_s, "steps": n,
               "attempted": n,
               "e2e": {"train_graphs_per_s": B * n / window_s,
                       "setup_s": setup_s},
               "device": device_record(device, 1)}
        if traced:
            out["record"] = _record(tn, w["prof_steps"], w["prof"])
        tn.state = None
        tn.run = None
        values = check(first, tn.corpus, cell, device)
        out["correct"], out["checks"] = judge(values, cell.limits)
        out["failed"] = 0 if out["correct"] else tr["check_steps"]
        out["values"] = values
        return out
    finally:
        tn.close()


def _record(tn: Trainer, prof_steps, prof) -> Dict:
    import json
    rec = {"kind": "train",
           "data_ms": [1e3 * s for s in tn.data_s]}
    if prof is None:
        return rec
    lo, hi = prof_steps
    dev, host = trace.events(prof)
    rec["dev"], rec["host"] = dev, host
    rec["traced_steps"] = hi - lo
    cfg = tn.cfg.to_dict()
    dcfg = cfg["model"]["denoiser"]
    ops = 0.0
    for nl, npc, NL, NP in tn.masks[lo:hi]:
        d = workcount.dims_for(dcfg, NP, NL)
        ops += workcount.network_ops(
            d, workcount.slots(nl, npc, d),
            dcfg["num_layers"] * dcfg["num_blocks"],
            cfg["model"]["num_atom_classes"], cfg["model"]["num_bond_classes"],
            cfg["model"]["diff"]["time_dim"], npc, 1)
    rec["forward_ops"] = ops
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(here, "peaks.json")) as f:
        rec["peaks"] = json.load(f)
    return rec


# ----- the check ---------------------------------------------------------

def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(np.median(list(rn.values())))
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med) for n in names}


def reference_readings(first: Dict, corpus, cell, device, bits: int = 0,
                       ref=None) -> Dict[str, float]:
    """The check's numbers of a run whose first steps are `first`, with
    the reference at float32 (or, with `bits`, at that many mantissa bits
    in the program's place, for the control)."""
    from ..reference.training import RefTrainer, rebuild_batch
    conf = cell.config
    tcfg = conf["config"]["train"]
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batches, bad, seen = [], 0, []
    for host in first["hosts"]:
        rows = {k: np.asarray(getattr(host, k)) for k in (
            "lig_type", "lig_pos", "lig_mask", "bond_type", "phore_x",
            "phore_pos", "phore_norm", "phore_mask", "center")}
        b, idx, nbad = rebuild_batch(rows, corpus, tcfg["phore_noise_std"],
                                     tcfg["phore_norm_angle"], device)
        batches.append(b)
        bad += nbad
        seen += idx
    # rows that all differ
    bad += len(seen) - len(set(seen))
    if ref is None:
        ref = RefTrainer(conf["config"], conf["checkpoint"], device)
    p0 = {n: p.detach().clone() for n, p in ref.net.named_parameters()}
    trained = first["trained"]
    losses, grad, params = ref.train(batches, first["draws"], trained, bits)
    out = {"batch_mismatch": float(bad)}
    return out, losses, grad, params, p0, ref.step_terms


def check(first: Dict, corpus, cell, device) -> Dict[str, float]:
    return compare(first, *reference_readings(first, corpus, cell, device))


def compare(first, out, losses, grad, params, p0, ref_terms=None,
            report: bool = False) -> Dict[str, float]:
    """loss_gap: the worst step's |loss - reference| / |reference|;
    grad_gap: the median leaf's gap of the first gradient (`leaf_gaps`);
    change_gap: the median leaf's gap of the parameters' change after the
    steps; over the trained leaves whose reference gradient is at least a
    thousandth of the median leaf's (smaller ones move under Adam by
    round-off). The worst leaf swings from seed to seed (small leaves:
    LayerNorm biases, the edge-weight and count heads; see PERF.md), so
    both are held by their median leaf. `report` adds the worst leaves'
    names and gaps, and each loss term's gap at the worst step."""
    prog_loss = [float(x) for x in first["loss"]]
    out["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(prog_loss,
                                                               losses))
    norms = {n: float(g.double().norm()) for n, g in grad.items()}
    med = float(np.median(list(norms.values())))
    leaves = [n for n in first["trained"] if norms.get(n, 0.0) >= 1e-3 * med]
    g = leaf_gaps(first["grad"], grad, leaves)
    out["grad_gap"] = float(np.median(list(g.values())))
    dprog = {n: first["params"][n].float() - p0[n] for n in leaves}
    dref = {n: params[n] - p0[n] for n in leaves}
    c = leaf_gaps(dprog, dref, leaves)
    out["change_gap"] = float(np.median(list(c.values())))
    if report:
        out["report"] = {"grad_worst": sorted(g.items(),
                                              key=lambda x: -x[1])[:3],
                         "change_worst": sorted(c.items(),
                                                key=lambda x: -x[1])[:3],
                         "losses": [prog_loss, losses]}
        k = int(np.argmax([abs(a - b) / abs(b) for a, b in
                           zip(prog_loss, losses)]))
        if "terms" in first and ref_terms:
            ref_t = ref_terms[k]
            out["report"]["term_gaps"] = {
                n: (float(first["terms"][k][n]) - ref_t[n]) / abs(losses[k])
                for n in ref_t if n in first["terms"][k]}
    return out


def readings(cell, seeds, device, bits: int, with_control: bool = True):
    """Per seed: the program's first steps, the check's numbers for the
    program and for the control (the reference at `bits` mantissa bits in
    the program's place)."""
    tr = cell.traffic
    for seed in seeds:
        tn = Trainer(cell, device, seed)
        try:
            first = first_steps(tn, tr["check_steps"])
            tn.state = tn.run = None
            row = {"seed": seed}
            base = reference_readings(first, tn.corpus, cell, device)
            row["program"] = compare(first, dict(base[0]), *base[1:],
                                     report=True)
            row["program_report"] = row["program"].pop("report")
            if with_control:
                # the control in the program's place, judged by the
                # float32 reference
                low = reference_readings(first, tn.corpus, cell, device,
                                         bits)
                as_prog = dict(first, loss=low[1], grad=low[2],
                               params=low[3], terms=low[5])
                row["control"] = compare(as_prog, dict(base[0]), *base[1:],
                                         report=True)
                row["control_report"] = row["control"].pop("report")
            yield row
        finally:
            tn.close()
