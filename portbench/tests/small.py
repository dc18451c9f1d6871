"""Cells of BENCHMARK.json at a size a CPU test run holds: the same
configuration and traffic with fewer graphs a sampling pool and a smaller
training corpus (the training batch stays the cell's), a check of every
kept step, a few steps a window."""
import copy
import json
import os

from portbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def small_cell(name: str, **config_edits):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cell = harness.Cell(bench, name, ROOT)
    cell.config = copy.deepcopy(cell.config)
    tr = dict(cell.traffic)
    if tr["kind"] == "sample_pools":
        tr.update(batch=2, check_every=1, check_max=3, trace_steps=2)
    else:
        tr.update(corpus=dict(tr["corpus"], n=24), trace_steps=1)
    cell.traffic = tr
    for path, v in config_edits.items():
        node = cell.config["config"]
        *keys, last = path.split(".")
        for k in keys:
            node = node[k]
        node[last] = v
    return cell
