"""The port's CUDA layer-stack kernels against their plain PyTorch versions,
on the card. Imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Skips where no CUDA device is present (the kernels have no CPU mode)."""
import pytest
import torch

from phoregen_tpu_torch.ops import kernel_check as kc
from phoregen_tpu_torch.ops import layer_stack as ls


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


SHAPES = {
    "small": dict(B=2, NP=6, NL=8, H=16, heads=2, Wt=8, K=4, trip_k=3),
    "flagship_nl32": dict(B=4, NP=96, NL=32, trip_k=32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernels_match_plain(cuda, shape):
    case = kc.flagship_case(device=cuda, seed=1, **SHAPES[shape])
    rows = kc.check_kernels(case, reps=1)
    bad = [(r["name"], r["max_abs_err"]) for r in rows if not r["ok"]]
    assert not bad, bad


@pytest.mark.cuda
def test_wrappers_count_launches(cuda):
    case = kc.flagship_case(device=cuda, seed=2,
                            **SHAPES["small"])
    ls.reset_launch_counts()
    packed = {k: v[None] for k, v in case["w"].items()}
    ls.layer_stack(packed, case["h"], case["x"], case["hb"], case["t"],
                   case["d"])
    assert all(v == 1 for v in ls.LAUNCHES.values()), ls.LAUNCHES


@pytest.mark.cuda
def test_wrappers_reject_mismatched_shapes(cuda):
    case = kc.flagship_case(device=cuda, seed=3, **SHAPES["small"])
    w, t, d, h, x, hb = (case[k] for k in ("w", "t", "d", "h", "x", "hb"))
    ls.reset_launch_counts()
    with pytest.raises(ValueError, match="hb"):
        ls.stage_node(w, h, x, hb[:, 1:], t, d)
    with pytest.raises(ValueError, match="pre_t"):
        pre_t, q_z = ls.stage_triplet_pre_plain(w, h, x, hb, t, d)
        ls.stage_triplet_att(w, hb, pre_t[..., 1:, :], q_z, t, d)
    assert all(v == 0 for v in ls.LAUNCHES.values()), ls.LAUNCHES
