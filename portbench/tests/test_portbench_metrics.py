"""The metric arithmetic on synthetic inputs: the sampling rate with a
pool still open at the window's end, the 95th percentile, the busy time,
idle share and gaps of a device trace, and the readers' shares."""
import statistics

import pytest
import torch

from portbench import harness, trace
from portbench.kinds import sample_pools


class _Pools:
    """A stand-in for the program's pools: `S` steps a pool, nothing on a
    device."""

    def __init__(self, S, batch):
        self.S = S
        self.tr = {"batch": batch, "check_every": 7, "trace_steps": 2}
        self.seed = 5
        self.device = torch.device("cpu")
        self.calls = 0

    def step(self, keep_this=False):
        self.calls += 1


def test_rate_counts_the_open_pool_for_its_finished_steps():
    p = _Pools(S=1000, batch=30)
    out = sample_pools.window(p, 0, False, steps_override=250)
    assert p.calls == 250 and out["steps"] == 250
    # a quarter of one pool of 30 graphs: 7.5 molecules' worth of steps
    assert out["sample_mol_per_s"] == pytest.approx(
        30 * 250 / 1000 / out["window_s"])


def test_p95_reader():
    read = harness.metric_reader("step_ms_p95.sample")
    iv = [10.0] * 95 + [20.0] * 5
    assert read({"kind": "sample", "step_ms": iv}) == \
        statistics.quantiles(iv, n=20)[18]
    assert read({"kind": "sample", "step_ms": [1.0] * 5}) is None
    assert read({"kind": "train", "step_ms": iv}) is None


EV = [("a", 0.0, 10.0), ("b", 5.0, 12.0), ("c", 20.0, 30.0),
      ("a", 40.0, 50.0)]
HOST = [("outer", -5.0, 60.0), ("aten::item", 11.0, 21.0),
        ("cudaStreamSynchronize", 29.0, 39.0)]


def test_busy_union_window_and_gaps():
    assert trace.busy_us(EV) == 12 + 10 + 10
    assert trace.window_us(EV) == 50
    assert trace.gaps(EV) == [(12.0, 20.0), (30.0, 40.0)]


def test_idle_gaps_are_labelled_by_the_innermost_host_op():
    assert trace.idle_gaps(EV, HOST) == [
        ["cudaStreamSynchronize", pytest.approx(10e-6)],
        ["aten::item", pytest.approx(8e-6)]]
    assert trace.top_ops(EV)[0] == ["a", pytest.approx(20e-6)]


def test_share_readers():
    rec = {"kind": "sample", "dev": EV, "traced_steps": 2,
           "ops_per_step": 1e3, "stack_roofline_s_per_step": 4e-6,
           "peaks": {"tf32_flops_per_s": 1e9}}
    idle = harness.metric_reader("idle_share.sample")(rec)
    assert idle == pytest.approx(100 * (1 - 32 / 50))
    assert harness.metric_reader("launches_per_step.sample")(rec) == 2.0
    mfu = harness.metric_reader("mfu.sample")(rec)
    assert mfu == pytest.approx(100 * 2e3 / 50e-6 / 1e9)
    # no stage kernel in the trace: no roofline share (never 0)
    assert harness.metric_reader("stack_roofline.sample")(rec) is None
    rec["dev"] = EV + [("void node_kernel<...>", 60.0, 70.0)]
    assert harness.metric_reader("stack_roofline.sample")(rec) == \
        pytest.approx(100 * 8e-6 / 10e-6)
    rec["stack_roofline_s_per_step"] = None
    assert harness.metric_reader("stack_roofline.sample")(rec) is None


def test_training_readers():
    rec = {"kind": "train", "dev": EV, "traced_steps": 2,
           "forward_ops": 1e3, "peaks": {"bf16_flops_per_s": 1e9},
           "data_ms": [1.0, 3.0]}
    assert harness.metric_reader("data_ms.train")(rec) == 2.0
    assert harness.metric_reader("mfu.train")(rec) == pytest.approx(
        100 * 3e3 / 50e-6 / 1e9)
    assert harness.metric_reader("idle_share.train")(rec) == \
        pytest.approx(100 * (1 - 32 / 50))
    assert harness.metric_reader("mfu.sample")(rec) is None


def test_judge():
    ok, checks = harness.judge({"a": 1.0, "b": 0.0}, {"a": 2.0, "b": 0.0})
    assert ok and checks == [("a", 1.0, 2.0), ("b", 0.0, 0.0)]
    assert not harness.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not harness.judge({"a": float("nan")}, {"a": 2.0})[0]
    assert not harness.judge({}, {"a": 2.0})[0]
    assert not harness.judge({"a": 1.0}, {})[0]
