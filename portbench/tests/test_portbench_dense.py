"""The dense cell's own pieces on the CPU: the dense layer's work count
pinned by hand, the device-range arithmetic and its reader of a profile
on synthetic annotation events, the three readers on synthetic records,
the cell found by its names, a run of the cell at a small size (traced,
correct; with each fault and under the TF32 control, not), and the
existing cells' records as they were."""
import json
import os
import time

import pytest

from portbench import control, devspans, faults, harness, workcount_dense
from portbench.kinds import sample_pools, sample_pools_dense
from portbench.reference.precision import BITS

from .dense_small import NAME, small_dense_cell
from .small import small_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ("triplet_ms.sample", "triplet_roofline.sample",
       "real_triplet_share.sample")


def test_work_count_pinned_by_hand():
    """Graphs of 3 and 4 atoms at H=8 with 2 heads: 7 rows, 6 + 12 bonds,
    6 + 24 triplets."""
    c = workcount_dense.graph_counts([3, 4])
    assert c == {"rows": 7, "pairs": 18, "trips": 30}
    by, ops = workcount_dense.layer_work(c, 8, 2)
    row = 8 * 64 + 2 * 64                 # h(k), h(j) of 2 branches; h(i)
    pair = (4 * (28 * 8 + 20 * 8)         # bond state + rbf, rbf j -> i
            + 2 * 20 * 4 + 8              # distance and radial basis
            + 2 * 64 + 8 * 8 + 2 * 64     # query MLP
            + 2 * 64 + 2 * 8              # key output folded into q
            + 2 * 64 + 8)                 # value output after the pool
    trip = (20 + 2 * (2 * 13 * 8 + 2 * 8 + 8 * 8)   # angle, pre, LN, act
            + 2 * 8 * 2 + 4 * 2 + 2 * 8 * 2)        # scores, softmax, pool
    assert ops == 7 * row + 18 * pair + 30 * trip == 65992
    # h and positions of 7 atoms, bond states in and out of 18 bonds,
    # and the layer's 1648 parameters
    params = (16 * 8 + 8 + 2 * 8 + 8 * 8 + 8
              + 2 * ((44 * 8 + 8) + 20 * 8 + 13 * 8 + (8 * 8 + 8) + 2 * 8))
    assert params == 1648
    assert by == 4 * (7 * 11 + 2 * 18 * 8) + 4 * params == 8052


def test_roofline_is_compute_bound_at_the_cells_counts():
    conf = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       "upstream-dense.json")))["config"]
    peaks = json.load(open(os.path.join(ROOT, "portbench", "peaks.json")))
    counts = [17, 26, 35]
    by, ops = workcount_dense.layer_work(
        workcount_dense.graph_counts(counts), 128, 16)
    assert ops / peaks["tf32_flops_per_s"] > by / peaks["hbm_bytes_per_s"]
    assert workcount_dense.roofline_s(conf, counts, peaks) == \
        pytest.approx(6 * ops / peaks["tf32_flops_per_s"])
    # the dense network counts more than the factorized stages it replaces
    dense = workcount_dense.network_ops(conf, 44, 48, counts, [44] * 3,
                                        1000)
    assert dense > 6 * ops


DEV = [("k1", 0.0, 10.0), ("k2", 10.0, 14.0), ("k3", 20.0, 30.0),
       ("k4", 35.0, 40.0), ("k5", 38.0, 45.0)]
RANGES = [("sample.network", 0.0, 45.0), ("bond.triplet", 8.0, 22.0),
          ("bond.triplet", 36.0, 50.0)]


def test_busy_time_inside_the_device_ranges():
    assert devspans.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert devspans.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    got = devspans.busy_inside_us(DEV, RANGES)
    # busy: [0, 14] [20, 30] [35, 45]; bond.triplet: [8, 22] [36, 50]
    assert got == {"bond.triplet": pytest.approx(6 + 2 + 9),
                   "sample.network": pytest.approx(14 + 10 + 10)}
    assert devspans.per_step_ms(DEV, RANGES, 2)["bond.triplet"] == \
        pytest.approx(17 / 2 / 1e3)


class _Event:
    """A kineto event as the profiler hands it over."""

    def __init__(self, name, device, start, dur, annotation, act=""):
        self._v = (name, device, start, dur, annotation, act)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2] * 1e3

    def duration_ns(self):
        return self._v[3] * 1e3

    def is_user_annotation(self):
        return self._v[4]

    def activity_type(self):
        return self._v[5]


def test_ranges_are_the_device_side_annotations():
    evs = [_Event("bond.triplet", "CUDA", 36.0, 14.0, True),
           _Event("sample.network", "CUDA", 0.0, 45.0, False,
                  "ActivityType.GPU_USER_ANNOTATION"),
           _Event("bond.triplet", "CPU", 1.0, 2.0, True),
           _Event("gemm", "CUDA", 3.0, 1.0, False, "ActivityType.KERNEL")]
    prof = type("P", (), {})()
    prof.profiler = type("Q", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda s: evs})()
    assert devspans.ranges(prof) == [("sample.network", 0.0, 45.0),
                                     ("bond.triplet", 36.0, 50.0)]


def _read(name, rec):
    return harness.metric_reader(name)(rec)


def test_triplet_readers():
    rec = {"kind": "sample", "span_dev_ms": {"bond.triplet": 250.0,
                                             "sample.step": 300.0},
           "triplet_roofline_s_per_step": 1e-4}
    assert _read("triplet_ms.sample", rec) == 250.0
    assert _read("triplet_roofline.sample", rec) == pytest.approx(0.04)
    # the program before its span, a cell of another kind, another record
    bare = dict(rec, span_dev_ms={"sample.step": 300.0})
    for name in NEW[:2]:
        assert _read(name, bare) is None
        assert _read(name, dict(rec, kind="train")) is None
        assert _read(name, {"kind": "sample", "step_ms": [1.0]}) is None
    assert _read("triplet_roofline.sample",
                 dict(rec, triplet_roofline_s_per_step=None)) is None


def test_real_triplet_share_reader(monkeypatch):
    from phoregen_tpu_torch.data import batching
    name = "real_triplet_share.sample"
    monkeypatch.setattr(batching, "SLOTS", {
        "lig_real": 8, "lig_slots": 16, "trip_real": 66,
        "trip_slots": 1024})
    assert _read(name, {"kind": "sample"}) == pytest.approx(6.4453125)
    assert _read(name, {"kind": "train"}) is None
    # the program before its triplet counter, and before any counter
    monkeypatch.setattr(batching, "SLOTS", {"lig_real": 8, "lig_slots": 16})
    assert _read(name, {"kind": "sample"}) is None
    monkeypatch.delattr(batching, "SLOTS")
    assert _read(name, {"kind": "sample"}) is None


def test_the_cell_is_found_by_its_names():
    cell = harness.Cell(BENCH, NAME)
    assert cell.chips == 1 and cell.config_entry["reduced"] == []
    assert cell.config["config"]["model"]["denoiser"]["triplet_mode"] == \
        "dense"
    assert harness.kind_module(cell.traffic["kind"]) is sample_pools_dense
    assert set(cell.limits) == {"net_err", "post_err", "pos_err",
                                "choice_mismatch"}
    names = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= names and "stack_roofline.sample" not in names
    assert {m["name"] for m in cell.end_to_end} == {"sample_mol_per_s",
                                                    "setup_s"}


def test_small_cell_runs_traced_and_correct(tmp_path):
    cell = small_dense_cell(tmp_path)
    out = sample_pools_dense.run(cell, 2**31 + 41, 0, True, "cpu",
                                 time.perf_counter(), steps_override=4)
    assert out["correct"], out["values"]
    rec = out["record"]
    assert rec["ops_per_step"] > 0 and rec["triplet_roofline_s_per_step"] > 0
    assert rec["span_dev_ms"] == {}     # no device here
    assert _read("real_triplet_share.sample", rec) is not None


@pytest.mark.parametrize("fault", faults.SAMPLING)
def test_small_cell_with_a_fault_is_not_correct(tmp_path, fault):
    cell = small_dense_cell(tmp_path)
    with faults.planted("sample_pools", fault):
        out = sample_pools_dense.run(cell, 2**31 + 43, 0, False, "cpu",
                                     time.perf_counter(), steps_override=3)
    assert not out["correct"] and out["failed"] > 0, out["values"]


def test_small_cell_control_fails(tmp_path):
    cell = small_dense_cell(tmp_path)
    row = next(sample_pools_dense.readings(
        cell, [2**31 + 47], 0, "cpu", BITS["tf32"], steps_override=3))
    assert harness.judge(row["program"], cell.limits)[0], row
    assert not harness.judge(row["control"], cell.limits)[0], row
    assert control.LOWER["float32"] == "tf32"


def test_existing_cells_records_are_as_they_were():
    """A traced run of the module-path cell keeps its record's keys: the
    dense kind's keys are its own."""
    cell = small_cell("sample-lig-module")
    out = sample_pools.run(cell, 2**31 + 53, 0, True, "cpu",
                           time.perf_counter(), steps_override=3)
    assert set(out["record"]) == {
        "kind", "step_ms", "dev", "host", "traced_steps", "peaks",
        "ops_per_step", "stack_roofline_s_per_step"}
    for w in ("sample-lig-module", "sample-cpx-pallas"):
        assert harness.Cell(BENCH, w).traffic["kind"] == "sample_pools"
