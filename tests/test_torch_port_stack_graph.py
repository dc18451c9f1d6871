"""`LayerStackFn.backward`'s per-layer recompute as one captured CUDA graph
(`ops/layer_stack.py::_LayerGraph`) against the same function run eagerly,
and the device-resident constant tables the plain stages read. Imports
neither JAX nor the JAX package, so the card cases also run where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_stack_graph.py

On the CPU the graph's bookkeeping (static inputs copied in before each
replay, outputs copied out before the next) is held with a stand-in for
the capture that reruns the function at each replay; the card cases
capture for real and skip without a CUDA device."""
import pytest
import torch

from phoregen_tpu_torch.ops import kernel_check as kc
from phoregen_tpu_torch.ops import layer_stack as ls
from phoregen_tpu_torch.ops import rbf
from phoregen_tpu_torch.ops.rbf import (angular_encoding_freq_bands,
                                        gaussian_smearing_offsets)

SMALL = dict(B=2, NP=6, NL=8, H=16, heads=2, Wt=8, K=4, trip_k=3)
L = 3
# (merge_node_pre, merge_pos, block_dtype)
SETTINGS = {"pallas": (False, False, torch.float32),
            "pallas3": (True, False, torch.float32),
            "pallas2": (True, True, torch.float32),
            "pallas2_bf16_blocks": (True, True, torch.bfloat16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the stage kernels "
                    "have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def fresh_graphs(monkeypatch):
    """No graph captured yet, the counts at zero."""
    monkeypatch.setattr(ls, "_GRAPHS", {})
    ls.reset_stack_graph_counts()


class _FakeGraph:
    """A stand-in for a captured graph on the CPU: like a replay, `replay`
    reads the static inputs anew and rewrites in place the outputs the
    capture returned."""

    def __init__(self, fn):
        self.fn = fn
        self.outs = fn()

    def replay(self):
        for o, new in zip(self.outs, self.fn()):
            if o is not None:
                o.copy_(new)

    def pool(self):
        return None


def _fake_capture(fn, pool=None):
    graph = _FakeGraph(fn)
    return graph, graph.outs


def _call(device, seed, setting, shape=SMALL):
    """One forward and backward of the trainable stack on a new case (new
    weights, boundaries, tables and cotangents for each seed): the
    gradients of every leaf, in a fixed order."""
    merge_node_pre, merge_pos, block_dtype = SETTINGS[setting]
    case = kc.flagship_case(device=device, seed=seed, **shape)
    scale = torch.tensor([1.0, 0.9, 1.1][:L])
    packed = {k: (torch.stack([v] * L) * scale.to(v.device).reshape(
        -1, *[1] * v.dim())).requires_grad_(True)
        for k, v in case["w"].items()}
    ins = [case[k].clone().requires_grad_(True) for k in ("h", "x", "hb")]
    t = dict(case["t"])
    for k in ("e_w", "phore_norm"):
        t[k] = t[k].clone().requires_grad_(True)
    out = ls.make_layer_stack_grad(case["d"], merge_node_pre, merge_pos,
                                   block_dtype=block_dtype)(packed, *ins, t)
    g = torch.Generator().manual_seed(seed)
    cot = [torch.randn(o.shape, generator=g).to(o.device) for o in out]
    leaves = ins + [t["e_w"], t["phore_norm"]] + [packed[k]
                                                  for k in sorted(packed)]
    return torch.autograd.grad(out, leaves, cot, allow_unused=True)


# below this share of the largest gradient of any leaf, a leaf's gradient
# is rounding: a bias that shifts every score of a softmax alike (the
# position keys' `e_xk2b`) has a gradient of zero in exact arithmetic
NOISE = 1e-4


def _assert_same(got, want, rel):
    """Every leaf within `rel` of its largest gradient (a leaf whose
    gradient is rounding, within `rel` of the largest gradient of any
    leaf); unused alike."""
    assert len(got) == len(want)
    top = max(float(b.abs().max()) for b in want if b is not None)
    for i, (a, b) in enumerate(zip(got, want)):
        if b is None or a is None:
            assert a is None and b is None, i
            continue
        assert torch.isfinite(a).all(), i
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if scale < NOISE * top:
            scale = top
        assert err <= rel * scale, (i, err, scale)


# ----- CPU ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_cached_tables_equal_the_numpy_built_ones(dtype):
    """`_rbf` and `_angular` read tables made once per (table, device,
    dtype) (`ops/rbf.py::_table`), bit for bit what the numpy tables cast
    to the distances' dtype on every call give."""
    g = torch.Generator().manual_seed(3)
    dist = (6.0 * torch.rand(4, 7, generator=g)).to(dtype)
    theta = (3.0 * torch.rand(4, 7, generator=g)).to(dtype)
    offsets, coeff = gaussian_smearing_offsets(fix_offset=True)
    d = dist[..., None] - torch.as_tensor(offsets, dtype=dtype)
    want_rbf = torch.exp(coeff * d * d)
    for num_ang in (3, 2):
        xf = theta[..., None] * torch.as_tensor(
            angular_encoding_freq_bands(num_ang), dtype=dtype)
        want_ang = torch.cat([theta[..., None], torch.sin(xf),
                              torch.cos(xf)], -1)
        for _ in range(2):               # made, then found in the cache
            got = ls._angular(theta, num_ang)
            assert got.dtype == want_ang.dtype and torch.equal(got, want_ang)
    for _ in range(2):
        got = ls._rbf(dist)
        assert got.dtype == want_rbf.dtype and torch.equal(got, want_rbf)
    # made by the calls above: found again, not copied again
    tab = rbf._table(offsets, dist.device, dtype)
    assert tab.dtype == dtype and tab.device == dist.device
    assert tab is rbf._table(offsets, dist.device, dtype)


def test_cpu_backward_runs_eagerly(fresh_graphs):
    _call("cpu", 1, "pallas2")
    assert ls.STACK_GRAPH == {"captures": 0, "replays": 0, "eager": L}
    assert not ls._GRAPHS


def test_graph_bookkeeping_on_the_cpu(fresh_graphs, monkeypatch):
    """Three calls with new weights, boundaries, tables and cotangents give
    the eager gradients through one captured layer replayed L times a call
    (a static input read stale, or an output copied out after the next
    replay, would not); a second shape captures a second graph."""
    eager = [_call("cpu", s, "pallas2") for s in (1, 2, 3)]
    other = dict(SMALL, B=3)
    eager_other = _call("cpu", 4, "pallas2", other)
    monkeypatch.setattr(ls, "_graphable", lambda t: True)
    monkeypatch.setattr(ls, "_capture", _fake_capture)
    ls.reset_stack_graph_counts()
    for s, want in zip((1, 2, 3), eager):
        _assert_same(_call("cpu", s, "pallas2"), want, 1e-6)
    assert ls.STACK_GRAPH == {"captures": 1, "replays": 3 * L, "eager": 0}
    _assert_same(_call("cpu", 4, "pallas2", other), eager_other, 1e-6)
    assert ls.STACK_GRAPH == {"captures": 2, "replays": 4 * L, "eager": 0}


# ----- the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_replayed_backward_matches_eager(cuda, fresh_graphs, monkeypatch,
                                         setting):
    """On the card, three calls with new weights, boundaries, tables and
    cotangents each: the replayed gradients equal the eager ones on the
    same inputs within 1e-6 of each leaf's largest gradient (the scatter
    adds of the gathers' backward sum in no fixed order); one capture and
    3 x L replays; a second shape key adds one capture."""
    graphable = ls._graphable
    monkeypatch.setattr(ls, "_graphable", lambda t: False)
    eager = [_call(cuda, s, setting) for s in (1, 2, 3)]
    other = dict(SMALL, B=3)
    eager_other = _call(cuda, 4, setting, other)
    assert ls.STACK_GRAPH["eager"] == 4 * L
    monkeypatch.setattr(ls, "_graphable", graphable)
    ls.reset_stack_graph_counts()
    for s, want in zip((1, 2, 3), eager):
        _assert_same(_call(cuda, s, setting), want, 1e-6)
    assert ls.STACK_GRAPH == {"captures": 1, "replays": 3 * L, "eager": 0}
    _assert_same(_call(cuda, 4, setting, other), eager_other, 1e-6)
    assert ls.STACK_GRAPH == {"captures": 2, "replays": 4 * L, "eager": 0}


@pytest.mark.cuda
def test_replayed_backward_makes_no_synchronizing_call(cuda, fresh_graphs):
    """After the capture, a backward of the same shapes makes no call that
    waits for the device: run under `set_sync_debug_mode("error")`, any
    such call raises."""
    case = kc.flagship_case(device=cuda, seed=7, **SMALL)
    packed = {k: torch.stack([v] * L).requires_grad_(True)
              for k, v in case["w"].items()}
    f = ls.make_layer_stack_grad(case["d"], True, True)
    leaves = list(packed.values())
    for k in range(2):
        out = f(packed, case["h"], case["x"], case["hb"], case["t"])
        loss = sum(o.sum() for o in out)
        torch.cuda.synchronize()
        mode = "error" if k else "default"
        torch.cuda.set_sync_debug_mode(mode)
        try:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert ls.STACK_GRAPH == {"captures": 1, "replays": 2 * L, "eager": 0}
    assert all(g is None or torch.isfinite(g).all() for g in grads)
