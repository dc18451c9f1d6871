"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell's files
are found by the names in BENCHMARK.json (`portbench/harness.py`); its
traffic's `kind` names the driver in `portbench/kinds/`. With `--trace 0`
the result's metrics are the cell's end-to-end metrics; with `--trace 1`
its per-layer metrics, read from the traced run by
`portbench/metrics/<name>.py`. The numbers that decide `correct` are
printed beside their limits as the last lines of standard error and as
the last key of the result line. A run without enough CUDA devices, or
with JAX or the JAX package loaded, prints no result and exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def result_line(cell, out: dict, traced: bool) -> dict:
    """The contract's keys: metrics (end-to-end or per-layer), correct,
    attempted, failed, device; a breakdown with a trace; the compared
    numbers last."""
    from . import harness
    if traced:
        rec = out["record"]
        metrics = {}
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = dict(out["device"])
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        from . import trace
        rec = out["record"]
        dv = rec.get("dev", [])
        dev["busy_s"] = trace.busy_us(dv) / 1e6
        dev["window_s"] = trace.window_us(dv) / 1e6
        line["breakdown"] = {"device_ops": trace.top_ops(dv),
                             "idle_gaps": trace.idle_gaps(dv,
                                                          rec.get("host", []))}
    line["compared"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    from . import harness
    root = harness.checkout_root()
    harness.set_cache_dirs(root)
    t_origin = time.perf_counter() - harness.process_age_s()
    cell = harness.Cell(harness.load_json("BENCHMARK.json"), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[E] {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    kind = harness.kind_module(cell.traffic["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_origin)
    line = result_line(cell, out, bool(args.trace))
    # last, after the metric readers have been loaded too
    bad = harness.forbidden_modules()
    if bad:
        print(f"[E] loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for text in harness.check_lines(out["checks"]):
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
