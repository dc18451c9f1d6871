"""Readings that set the limits of `correct` in a cell of kind
`sample_pools_dense`, in one process per cell: `portbench.control` for
this kind, whose reference holds the published bond update in its
upstream form (`kinds/sample_pools_dense.py::reference`).

    python3 -m portbench.control_dense --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed: a window of `--seconds`, then the numbers the run's check
compares, for the program ("program") and, without `--fault`, for the
control ("control": the reference with every matrix product's operands at
TF32 in the program's place, judged against the float32 reference). With
`--fault`, the program's numbers with that sampling fault planted in its
timed path (`portbench/faults.py`). One JSON line per seed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import faults, harness
from .control import LOWER
from .reference.precision import BITS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    harness.set_cache_dirs(harness.checkout_root())
    cell = harness.Cell(harness.load_json("BENCHMARK.json"), args.workload)
    if cell.traffic["kind"] != "sample_pools_dense":
        print(f"[E] {args.workload} is not of kind sample_pools_dense: use "
              f"python3 -m portbench.control", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[E] needs a CUDA device", file=sys.stderr)
        return 2
    from .kinds import sample_pools_dense
    lower = LOWER[cell.config["config"]["model"]["compute_dtype"]]
    t0 = time.perf_counter()
    rows = sample_pools_dense.readings(cell, args.seeds, args.seconds,
                                       "cuda", BITS[lower],
                                       with_control=not args.fault)
    with (faults.planted("sample_pools", args.fault) if args.fault
          else contextlib.nullcontext()):
        for row in rows:
            row["elapsed_s"] = time.perf_counter() - t0
            row["control_precision"] = lower
            row["fault"] = args.fault or None
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
