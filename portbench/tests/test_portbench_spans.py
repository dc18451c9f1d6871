"""The readers of the program's spans and counter on synthetic host and
device events: span durations, the synchronizing calls inside a span,
device gaps by the innermost open span (past the 256 host ops that
`trace.host_label` looks back), and the nine readers, which read nothing
where the program has no span or counter."""
import pytest

from phoregen_tpu_torch.data import batching
from portbench import harness, spans, trace

# two sampling steps of 10 us, each with its four phases; the first
# waits 3 us for the device inside its posterior, the second 1 us in an
# event synchronize; a synchronize outside every step is not counted
SAMPLE_HOST = [
    ("sample.step", 0.0, 10.0), ("sample.network", 0.0, 4.0),
    ("aten::mm", 0.5, 1.0), ("cudaLaunchKernel", 0.6, 0.7),
    ("sample.posterior", 4.0, 8.0), ("aten::item", 5.0, 8.0),
    ("cudaStreamSynchronize", 5.0, 8.0),
    ("sample.guidance", 8.0, 9.0), ("sample.position", 9.0, 10.0),
    ("cudaDeviceSynchronize", 10.5, 11.5),
    ("sample.step", 12.0, 22.0), ("sample.network", 12.0, 16.0),
    ("sample.posterior", 16.0, 18.0), ("sample.guidance", 18.0, 20.0),
    ("sample.position", 20.0, 22.0), ("cudaEventSynchronize", 21.0, 22.0),
]
SAMPLE_DEV = [("k", 1.0, 4.5), ("k", 6.0, 9.5), ("k", 13.0, 20.0)]

# two train steps; the stack's backward runs on another thread inside the
# backward's interval
TRAIN_HOST = [
    ("data.batch", 0.0, 2.0), ("data.to_device", 2.0, 3.0),
    ("train.forward", 3.0, 30.0), ("train.backward", 30.0, 90.0),
    ("autograd::engine::evaluate_function", 31.0, 89.0),
    ("stack.backward", 40.0, 80.0),
    ("train.clip", 90.0, 92.0), ("train.adam", 92.0, 96.0),
    ("train.ema", 96.0, 100.0),
    ("data.batch", 100.0, 104.0), ("data.to_device", 104.0, 105.0),
    ("train.forward", 105.0, 130.0), ("train.backward", 130.0, 190.0),
    ("stack.backward", 140.0, 180.0),
    ("train.clip", 190.0, 192.0), ("train.adam", 192.0, 194.0),
    ("train.ema", 194.0, 196.0),
]


def _read(name, rec):
    return harness.metric_reader(name)(rec)


def test_span_durations_and_the_calls_inside_them():
    steps = spans.named(SAMPLE_HOST, "sample.step")
    assert [s for _, s, _ in steps] == [0.0, 12.0]
    assert spans.total_us(SAMPLE_HOST, ("sample.network",
                                        "sample.guidance")) == 4 + 1 + 4 + 2
    assert spans.inside_us(SAMPLE_HOST, steps, spans.SYNC) == [3.0, 1.0]
    # a call that outlasts its span is cut at the span's end
    assert spans.inside_us([("s", 0.0, 5.0), ("cudaStreamSynchronize", 4.0,
                                              9.0)],
                           [("s", 0.0, 5.0)], spans.SYNC) == [1.0]


def test_idle_by_span_labels_each_gap_by_the_innermost_open_span():
    # the window opens at the first kernel; gaps 4.5-6 (in the posterior)
    # and 9.5-13 (labelled by the position phase, where it began)
    got = dict(spans.idle_by_span(SAMPLE_DEV, SAMPLE_HOST))
    assert got == {"sample.posterior": pytest.approx(1.5e-6),
                   "sample.position": pytest.approx(3.5e-6)}
    dev = [("k", 0.0, 1.0), ("k", 11.0, 12.0), ("k", 30.0, 31.0),
           ("k", 45.0, 46.0), ("k", 85.0, 86.0), ("k", 200.0, 201.0),
           ("k", 210.0, 211.0)]
    got = dict(spans.idle_by_span(dev, TRAIN_HOST))
    # the stack's backward on the worker thread is the innermost span
    # inside the backward's interval; after it the backward again
    assert got == {"data.batch": pytest.approx(10e-6),
                   "train.forward": pytest.approx(18e-6),
                   "train.backward": pytest.approx((14 + 114) * 1e-6),
                   "stack.backward": pytest.approx(39e-6),
                   spans.OUTSIDE: pytest.approx(9e-6)}


def test_a_gap_far_past_the_breakdowns_look_back_is_still_labelled():
    """300 aten ops between the span's start and the gap: the breakdown's
    label (`trace.host_label`, 256 ops back) finds no span, this does."""
    host = [("train.backward", 0.0, 1000.0)]
    host += [("aten::mul", 1.0 + i, 1.5 + i) for i in range(300)]
    dev = [("k", 0.0, 400.0), ("k", 450.0, 460.0)]
    assert trace.idle_gaps(dev, host) == [["host idle",
                                           pytest.approx(50e-6)]]
    assert spans.idle_by_span(dev, host) == [["train.backward",
                                              pytest.approx(50e-6)]]
    # outside every span
    assert spans.idle_by_span([("k", 0.0, 1.0), ("k", 5.0, 6.0)], []) == [
        [spans.OUTSIDE, pytest.approx(4e-6)]]


def test_by_span_names_the_span_that_holds_the_waits():
    waits = [(s, e) for _, s, e in spans.named(SAMPLE_HOST, spans.SYNC)]
    got = dict(spans.by_span(SAMPLE_HOST, spans.PROGRAM_SPANS, waits))
    assert got == {"sample.posterior": pytest.approx(3e-6),
                   "sample.position": pytest.approx(1e-6),
                   spans.OUTSIDE: pytest.approx(1e-6)}


def test_sampling_span_readers():
    rec = {"kind": "sample", "host": SAMPLE_HOST, "dev": SAMPLE_DEV,
           "traced_steps": 2}
    assert _read("enqueue_ms.sample", rec) == pytest.approx(
        ((10 - 3) + (10 - 1)) / 2 / 1e3)
    assert _read("sync_wait_ms.sample", rec) == pytest.approx(
        (3 + 1) / 2 / 1e3)
    # no program span (the program before its spans): nothing, no raise
    bare = dict(rec, host=[e for e in SAMPLE_HOST if "." not in e[0]])
    for name in ("enqueue_ms.sample", "sync_wait_ms.sample"):
        assert _read(name, bare) is None
        assert _read(name, dict(rec, kind="train")) is None
        assert _read(name, {"kind": "sample", "step_ms": [1.0]}) is None


def test_training_span_readers():
    rec = {"kind": "train", "host": TRAIN_HOST, "traced_steps": 2}
    want = {"input_ms.train": (3 + 5) / 2 / 1e3,
            "forward_host_ms.train": (27 + 25) / 2 / 1e3,
            "backward_host_ms.train": (60 + 60) / 2 / 1e3,
            "stack_backward_ms.train": (40 + 40) / 2 / 1e3,
            "optimizer_host_ms.train": (10 + 6) / 2 / 1e3}
    bare = dict(rec, host=[("aten::mm", 0.0, 1.0)])
    for name, v in want.items():
        assert _read(name, rec) == pytest.approx(v)
        assert _read(name, bare) is None
        assert _read(name, dict(rec, kind="sample")) is None
        assert _read(name, {"kind": "train", "data_ms": [1.0]}) is None


@pytest.mark.parametrize("name,kind", [("real_slot_share.sample", "sample"),
                                       ("real_slot_share.train", "train")])
def test_slot_share_readers(name, kind, monkeypatch):
    monkeypatch.setattr(batching, "SLOTS", {"lig_real": 32,
                                            "lig_slots": 80})
    assert _read(name, {"kind": kind}) == pytest.approx(40.0)
    other = "train" if kind == "sample" else "sample"
    assert _read(name, {"kind": other}) is None
    monkeypatch.setattr(batching, "SLOTS", {"lig_real": 0, "lig_slots": 0})
    assert _read(name, {"kind": kind}) is None
    # the program before its counter
    monkeypatch.delattr(batching, "SLOTS")
    assert _read(name, {"kind": kind}) is None
