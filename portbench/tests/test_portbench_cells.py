"""Every cell of BENCHMARK.json is found by its names: its configuration
file, its traffic file and driver, its limits and the reader of each of
its per-layer metrics; and the file keeps to the benchmark's form."""
import json
import os
import re

import pytest

from portbench import harness

BENCH = json.load(open(os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_found_by_its_names(name):
    cell = harness.Cell(BENCH, name)
    assert cell.chips == 1
    assert cell.config["checkpoint"].startswith("release/")
    assert os.path.exists(cell.config["checkpoint"] + ".msgpack")
    harness.kind_module(cell.traffic["kind"])
    assert cell.limits, "every cell has its limits"
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.Cell(BENCH, "no-such-cell")


def test_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and not c["reduced"]
    files = [os.path.join(r, f) for r, _, fs in os.walk("portbench")
             for f in fs if "__pycache__" not in r]
    assert all(re.match(r"^[A-Za-z0-9_./-]+$", f) for f in files)
