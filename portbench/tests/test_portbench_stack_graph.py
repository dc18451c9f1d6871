"""The reader of the program's `STACK_GRAPH` counter (the stack backward's
layer recomputes, replayed or eager): a share where recomputes ran, and
nothing on a program without the counter or before any recompute."""
import pytest

from phoregen_tpu_torch.ops import layer_stack
from portbench import harness

NAME = "stack_graph_share.train"


def test_reads_the_share_of_replayed_recomputes(monkeypatch):
    read = harness.metric_reader(NAME)
    monkeypatch.setattr(layer_stack, "STACK_GRAPH",
                        {"captures": 1, "replays": 18, "eager": 6},
                        raising=False)
    assert read({"kind": "train"}) == pytest.approx(75.0)
    assert read({"kind": "sample"}) is None
    monkeypatch.setattr(layer_stack, "STACK_GRAPH",
                        {"captures": 0, "replays": 0, "eager": 0},
                        raising=False)
    assert read({"kind": "train"}) is None


def test_reads_nothing_on_a_program_without_the_counter(monkeypatch):
    monkeypatch.delattr(layer_stack, "STACK_GRAPH", raising=False)
    assert harness.metric_reader(NAME)({"kind": "train"}) is None
