"""The port's all-k triplet pool (`ops/pallas_triplet.py`) against the JAX
package's, on the same numpy inputs (B=2, N=8, Wt=8, 2 heads, padded
slots in graph 0).

Tolerances: 2e-5 against `triplet_pool_xla` (the same float32 arithmetic
on materialised grids; only summation order differs); 2e-4 against
`triplet_pool_pallas(interpret=True)`, the JAX package's own tolerance for
its kernel (polynomial atan2, Newton-refined rsqrt); gradients 1e-4
against `jax.grad` through `triplet_pool_xla`.

The masks with holes and the graphs of fewer than three atoms hold the
semantics that the CUDA kernel's skipping must keep (it runs sources and
targets only up to a graph's last valid atom); the work its bound is
reckoned from (`kernel_check._triplet_work`) is pinned at the two shapes
the card times."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from phoregen_tpu.models.layers import ACTS as JACTS
from phoregen_tpu.ops.pallas_triplet import (triplet_pool_pallas,
                                             triplet_pool_xla)

from phoregen_tpu_torch.ops import pallas_triplet as pt

NAMES = ("a_kj", "a_ji", "q", "pos", "mask", "w_ang", "ln_s", "ln_b")


def make_inputs(seed=0, B=2, N=8, Wt=8, heads=2, mask=None):
    rng = np.random.default_rng(seed)
    f = np.float32
    if mask is None:
        mask = np.ones((B, N), bool)
        mask[0, -2:] = False
    B, N = mask.shape
    return dict(
        a_kj=rng.normal(size=(B, N, N, Wt)).astype(f),
        a_ji=rng.normal(size=(B, N, N, Wt)).astype(f),
        q=rng.normal(size=(B, N, N, heads, Wt)).astype(f),
        pos=(2 * rng.normal(size=(B, N, 3))).astype(f), mask=mask,
        w_ang=(0.3 * rng.normal(size=(13, Wt))).astype(f),
        ln_s=rng.uniform(0.5, 1.5, Wt).astype(f),
        ln_b=(0.1 * rng.normal(size=Wt)).astype(f))


def J(x):
    return [jnp.asarray(x[k]) for k in NAMES]


def T(x, grad=False):
    out = [torch.from_numpy(x[k].copy()) for k in NAMES]
    if grad:
        for t in out:
            if t.dtype == torch.float32:
                t.requires_grad_(True)
    return out


@pytest.mark.parametrize("norm", [True, False])
def test_plain_matches_xla(norm):
    x = make_inputs()
    want = np.asarray(triplet_pool_xla(*J(x), act=nn.relu, norm=norm))
    got = pt.triplet_pool_plain(*T(x), "relu", norm).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # target bonds with a padded j or i pool to exactly 0
    m = x["mask"]
    assert (got[0, ~m[0]] == 0).all() and (got[0][:, ~m[0]] == 0).all()


@pytest.mark.parametrize("norm", [True, False])
def test_plain_matches_pallas_interpret(norm):
    x = make_inputs(1)
    want = np.asarray(triplet_pool_pallas(*J(x), act=nn.relu, norm=norm,
                                          interpret=True))
    got = pt.triplet_pool_plain(*T(x), "relu", norm).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("act", sorted(pt.ACTS))
def test_activations_match_jax(act):
    x = make_inputs(2)
    want = np.asarray(triplet_pool_xla(*J(x), act=JACTS[act], norm=True))
    got = pt.triplet_pool_plain(*T(x), act, True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert sorted(pt.ACTS) == sorted(JACTS)


# masks that are not a prefix of valid slots
MASKS = {
    # holes inside the valid range; graph 0 ends on padding, graph 1 on an
    # atom
    "holes": np.array([[1, 0, 1, 1, 0, 1, 1, 0],
                       [0, 1, 1, 0, 1, 1, 1, 1]], bool),
    # 0, 1 and 2 valid atoms: no triplet at all, every output exactly 0
    "under_three": np.array([[0, 0, 0, 0, 0, 0, 0, 0],
                             [0, 0, 0, 1, 0, 0, 0, 0],
                             [0, 1, 0, 0, 0, 1, 0, 0]], bool),
}


@pytest.mark.parametrize("reference", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plain_matches_jax_on_sparse_masks(mask, reference):
    x = make_inputs(6, mask=MASKS[mask])
    if reference == "xla":
        want = triplet_pool_xla(*J(x), act=nn.relu, norm=True)
        tol = 2e-5
    else:
        want = triplet_pool_pallas(*J(x), act=nn.relu, norm=True,
                                   interpret=True)
        tol = 2e-4
    want = np.asarray(want)
    got = pt.triplet_pool_plain(*T(x), "relu", True).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    m = x["mask"]
    pair = m[:, :, None] & m[:, None, :] & ~np.eye(m.shape[1], dtype=bool)
    assert (got[~pair] == 0).all()
    if mask == "under_three":
        assert (got == 0).all() and (want == 0).all()


# (bytes, float32 operations) of `kernel_check.triplet_case` at B=16, 16
# heads, Wt=32, seed 0, and how PERF.md's kernel table prints them
TRIPLET_WORK = {48: (118978944, 2110176768, "119.0 MB", "2.11 G"),
                80: (352157056, 12320284032, "352.2 MB", "12.32 G")}


@pytest.mark.parametrize("n", sorted(TRIPLET_WORK))
def test_triplet_work_of_the_bound_is_pinned(n):
    from phoregen_tpu_torch.ops import kernel_check as kc
    c = kc.triplet_case(B=16, N=n, device="cpu", seed=0)
    by, fl = kc._triplet_work(c)
    want_by, want_fl, mb, g = TRIPLET_WORK[n]
    assert (by, fl) == (want_by, want_fl)
    assert (f"{by / 1e6:.1f} MB", f"{fl / 1e9:.2f} G") == (mb, g)
    # the operations count the valid triplets (k, j, i pairwise different
    # atoms of one graph), each (2 * 13 + 8 + 4 * 16) * 32 operations
    atoms = [int(v) for v in c["mask"].sum(-1)]
    assert fl == sum(a * (a - 1) * (a - 2) for a in atoms) * 32 * 98
    # the bytes: the output in full, q, a_ji and a_kj on the ordered pairs
    # of two valid atoms, positions and mask, w_ang and LayerNorm
    pairs = sum(a * (a - 1) for a in atoms if a >= 3)
    assert by == 4 * (16 * n * n * 16 * 32 + pairs * (16 + 2) * 32
                      + 16 * n * 4 + 13 * 32 + 2 * 32)


def _degenerate(x):
    """Atoms 1, 2, 3 of graph 1 on one line (an exactly collinear triplet);
    k == i triplets are in every input."""
    x = dict(x)
    pos = x["pos"].copy()
    pos[1, 2] = pos[1, 1] + np.float32(0.5) * (pos[1, 3] - pos[1, 1])
    x["pos"] = pos
    return x


@pytest.mark.parametrize("use_pallas", [True, False])
def test_gradients_match_jax_and_stay_finite(use_pallas):
    x = _degenerate(make_inputs(3))
    diff = [i for i, k in enumerate(NAMES) if k != "mask"]

    def loss(*a):
        full = list(a[:4]) + [jnp.asarray(x["mask"])] + list(a[4:])
        return jnp.sum(triplet_pool_xla(*full, act=nn.relu, norm=True) ** 2)
    jx = J(x)
    want = jax.grad(loss, argnums=tuple(range(7)))(*[jx[i] for i in diff])

    tx = T(x, grad=True)
    out = pt.triplet_pool(*tx, "relu", True, use_pallas=use_pallas)
    (out ** 2).sum().backward()
    for i, w in zip(diff, want):
        g = tx[i].grad.numpy()
        assert np.isfinite(g).all(), NAMES[i]
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=NAMES[i])


def test_function_forward_is_the_wrapper_on_cpu():
    """`use_pallas` on CPU tensors runs the plain version through the
    wrapper, launches nothing and gives the same values."""
    x = make_inputs(4)
    pt.reset_launch_counts()
    a = pt.triplet_pool(*T(x), "relu", True, use_pallas=True)
    b = pt.triplet_pool(*T(x), "relu", True, use_pallas=False)
    assert torch.equal(a, b)
    assert pt.LAUNCHES == {"triplet_pool": 0}


def test_gradient_without_norm_skips_ln_params():
    x = make_inputs(5)
    tx = T(x, grad=True)
    pt.triplet_pool(*tx, "relu", False, use_pallas=True).sum().backward()
    assert tx[6].grad is None and tx[7].grad is None
    assert torch.isfinite(tx[3].grad).all()
