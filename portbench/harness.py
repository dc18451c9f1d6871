"""What every cell shares: finding a cell's files by name, the cache
directories inside the checkout, the import guard, the device record and
the result line.

A cell (`workloads[]` of BENCHMARK.json) names a configuration and a
traffic mix; the harness reads
- `configs[].file` for the configuration (the program's configuration as
  run, with the checkpoint it loads),
- `portbench/traffic/<traffic>.json` for the traffic mix, whose `kind`
  names the general driver in `portbench/kinds/`,
- `portbench/limits/<workload>.json` for the limits of the numbers that
  decide `correct`,
- `portbench/metrics/<metric>.py` for each per-layer metric of the cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that must not be loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "phoregen_tpu")


def checkout_root() -> str:
    """The directory that holds BENCHMARK.json (the run's working
    directory)."""
    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "BENCHMARK.json")):
        raise SystemExit("[E] BENCHMARK.json is not in the working directory")
    return root


def set_cache_dirs(root: str) -> None:
    """Keep every build and kernel cache in fixed directories inside the
    checkout, so that only a checkout's first run builds, and keep
    libraries that can load JAX by themselves from doing so."""
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with everything found by its names."""

    def __init__(self, bench: Dict, name: str, root: str = "."):
        works = {w["name"]: w for w in bench["workloads"]}
        if name not in works:
            raise SystemExit(f"[E] no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(works)})")
        self.name = name
        self.workload = works[name]
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config_entry = conf
        self.config = load_json(os.path.join(root, conf["file"]))
        self.traffic_name = self.workload["traffic"]
        self.traffic = load_json(os.path.join(
            HERE, "traffic", self.traffic_name + ".json"))
        lim = os.path.join(HERE, "limits", name + ".json")
        self.limits = load_json(lim) if os.path.exists(lim) else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def kind_module(kind: str):
    """The general driver of a traffic kind: `portbench/kinds/<kind>.py`."""
    return importlib.import_module(f"portbench.kinds.{kind}")


def metric_reader(name: str):
    """`read(record) -> float | None` of `portbench/metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (`phoregen_tpu_torch` is not `phoregen_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_record(device, chips: int) -> Dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def check_lines(checks: List[Tuple[str, float, float]]) -> List[str]:
    return [f"{name} {value!r} limit {limit!r}"
            for name, value, limit in checks]


def judge(values: Dict[str, Optional[float]], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number present, finite and within its limit, the numbers
    beside their limits). A number without a limit, or a limit without a
    number, is not correct."""
    checks, ok = [], bool(limits)
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name), limits.get(name)
        if v is None or lim is None or not (v == v) or v > lim:
            ok = False
        checks.append((name, float("nan") if v is None else float(v),
                       float("nan") if lim is None else float(lim)))
    return ok, checks


def timed_window(step, seconds: float, traced: bool, trace_steps: int,
                 cuda: bool, steps_override: int = 0, events: bool = False
                 ) -> Dict:
    """Call `step(n)` for n = 0, 1, ... until `seconds` have passed (or,
    in tests, `steps_override` steps have run), then synchronize: the
    measured window. With `traced`, `trace_steps` steps from the window's
    middle on run under the profiler, and with `events` a CUDA event is
    recorded after each step's enqueue. Returns steps, window_s, the
    finished profile (`prof`, or None), the steps it covered
    (`prof_steps`) and the events [(steps done, event)]."""
    import time

    import torch

    from . import trace
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    evs, prof, done = [], None, None
    lo = hi = None
    t0 = time.perf_counter()
    n = 0
    while True:
        now = time.perf_counter() - t0
        if (steps_override and n >= steps_override) or \
                (not steps_override and now >= seconds):
            break
        if traced and lo is None and (n >= steps_override // 2
                                      if steps_override
                                      else now >= 0.5 * seconds):
            prof = trace.profile()
            prof.__enter__()
            lo = n
        step(n)
        n += 1
        if cuda and events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append((n, ev))
        if prof is not None and n - lo >= trace_steps:
            sync()
            prof.__exit__(None, None, None)
            done, prof, hi = prof, None, n
    sync()
    window_s = time.perf_counter() - t0
    if prof is not None:        # the window closed while tracing
        prof.__exit__(None, None, None)
        done, hi = prof, n
    return {"steps": n, "window_s": window_s, "prof": done,
            "prof_steps": (lo, hi), "events": evs}
