"""Readings that set the limits of `correct`, in one process per cell.

    python3 -m portbench.control --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed: the cell's set-up (the program loaded once for all
seeds), a window of `--seconds` at the cell's own load, then the numbers
the run's check compares, for the program ("program") and for the control
("control"): the plain reference put in the program's place with every
matrix product's operands rounded to the next lower precision than the
configuration states (`reference/precision.py`; TF32 below float32),
judged against the float32 reference on the same kept steps. With
`--fault`, the program's numbers with that fault planted in its timed
path (`portbench/faults.py`), and no control. Prints one JSON line per
seed. The benchmark's own runs do not run the control.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from . import faults, harness
from .reference.precision import BITS, RoundedProducts

# the precision stated by the configuration -> the next one below it
LOWER = {"float32": "tf32", "bfloat16": "fp8_e4m3"}


def sample_control(pools, cell, device, ref, bits: int) -> Dict[str, float]:
    """The sampling check's numbers with the reference at `bits` mantissa
    bits in the program's place."""
    from .kinds.sample_pools import compare_step, reference_steps
    values: Dict[str, float] = {}
    exact = reference_steps(pools, cell, device, ref)
    with RoundedProducts(bits):
        low = list(reference_steps(pools, cell, device, ref))
    for (p, s, r), (_, _, rl) in zip(exact, low):
        if s is None:
            nums = rl       # the set-up's numbers are computed in the mode
        else:
            prog = {"preds": (rl["pred_node"], rl["pred_pos"],
                              rl["pred_edge"]),
                    "state_out": {k: rl[k] for k in (
                        "log_node", "log_edge", "node", "edge", "pos")}}
            mask = torch.as_tensor(
                np.arange(p["n_lig"])[None] < p["counts"][:, None],
                device=device)
            nums = compare_step(prog, r, mask, s["draws"])
        for k, v in nums.items():
            values[k] = max(values.get(k, 0.0), v)
    return values


def sample_readings(cell, seeds, seconds: float, device: str, bits: int,
                    steps_override: int = 0, with_control: bool = True):
    from .kinds import sample_pools as sp
    from .reference.sampling import RefModel
    pg = sp.load_program(cell, device)
    ref = None
    for seed in seeds:
        pools = sp.warm(pg, cell, device, seed)
        w = sp.window(pools, seconds, False, steps_override)
        pools.free()
        if ref is None:
            ref = RefModel(cell.config["config"], cell.config["checkpoint"],
                           device)
        row = {"seed": seed, "steps": w["steps"],
               "sample_mol_per_s": w["sample_mol_per_s"],
               "program": sp.check_pools(pools, cell, device, ref)[0]}
        if with_control:
            row["control"] = sample_control(pools, cell, device, ref, bits)
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    root = harness.checkout_root()
    harness.set_cache_dirs(root)
    cell = harness.Cell(harness.load_json("BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available():
        print("[E] needs a CUDA device", file=sys.stderr)
        return 2
    kind = cell.traffic["kind"]
    conf = cell.config["config"]
    stated = (conf["train"]["dtype"] if kind == "finetune"
              else conf["model"]["compute_dtype"])
    lower = LOWER[stated]
    t0 = time.perf_counter()
    ctl = not args.fault
    if kind != "sample_pools":
        from .kinds import finetune
        rows = finetune.readings(cell, args.seeds, "cuda", BITS[lower],
                                 with_control=ctl)
    else:
        rows = sample_readings(cell, args.seeds, args.seconds, "cuda",
                               BITS[lower], with_control=ctl)
    with (faults.planted(kind, args.fault) if args.fault
          else contextlib.nullcontext()):
        for row in rows:
            row["elapsed_s"] = time.perf_counter() - t0
            row["control_precision"] = lower
            row["fault"] = args.fault or None
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
