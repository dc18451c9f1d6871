"""Stage A's bond-grid attention adds nothing to a padded ligand
destination, so its kernel may skip it.

`node_kernel` (csrc/layer_stack.cu) runs no bond-grid attention for a
ligand slot whose mask is 0: there the pool's weights are all exactly 0
(the pair mask holds the destination's mask), so it adds exact zeros to
the kNN edge attention. These tests show, on the CPU at a small size, that
the port's plain version (`stage_node_plain`, what the kernel is held to)
and the JAX package's `_stage_node` give the same new_h bits whatever the
bond features towards a padded destination hold: large finite values in
hb[b, :, dl, :] for every padded dl change no bit of either. The kernel
against the plain version on such inputs is held on the card
(tests/test_torch_port_cuda.py::test_node_kernel_skips_padded_destinations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.ops import layer_stack as jls
from phoregen_tpu_torch.ops import layer_stack as pls

import torch_port_common as C

TOL = dict(atol=1e-4, rtol=1e-4)
# large, finite, and leaving the bond grid's LayerNorm finite
FILL = 3.0e3


@pytest.fixture(scope="module")
def setup():
    tree = C.layer_tree(0)
    inp = C.stack_inputs(1)
    jt, nbr_idx, nbr_mask, etype = C.jax_tables(inp)
    pt = C.port_tables(inp, nbr_idx, nbr_mask, etype)
    jp = jls.pack_layer_params(jax.tree_util.tree_map(jnp.asarray, tree),
                               C.H, C.FE)
    pp = pls.pack_layer_params(C.tree_to_torch(tree), C.H, C.FE)
    jd = jls.StackDims(NP=C.NP, NL=C.NL, K=C.K, K8=min(C.TRIP_K, C.NL - 1),
                       H=C.H, heads=C.HEADS, Wt=C.WT)
    padded = [(b, dl) for b in range(C.B) for dl in range(C.NL)
              if not inp["node_mask"][b, C.NP + dl]]
    assert padded, "the inputs must hold a padded ligand slot"
    filled = inp["hb"].copy()
    rng = np.random.default_rng(7)
    for b, dl in padded:
        filled[b, :, dl, :] = FILL * np.sign(rng.normal(size=(C.NL, C.H)))
    return dict(inp=inp, jt=jt, pt=pt, jp=jp, pp=pp, jd=jd, padded=padded,
                filled=filled)


def _jax_new_h(s, layer, hb):
    jw = jax.tree_util.tree_map(lambda a: a[layer], s["jp"])
    inp = s["inp"]
    return np.stack([np.asarray(jls._stage_node(
        jw, inp["h"][b], inp["x"][b], hb[b],
        {k: v[b] for k, v in s["jt"].items()}, s["jd"]))
        for b in range(C.B)])


def _port_new_h(s, layer, hb):
    inp = s["inp"]
    return pls.stage_node_plain(
        pls.layer_weights(s["pp"], layer), torch.from_numpy(inp["h"]),
        torch.from_numpy(inp["x"]), torch.from_numpy(hb), s["pt"],
        C.dims()).numpy()


@pytest.mark.parametrize("layer", [0, 2])
def test_port_new_h_ignores_padded_destination_columns(setup, layer):
    s = setup
    before = _port_new_h(s, layer, s["inp"]["hb"])
    after = _port_new_h(s, layer, s["filled"])
    assert np.isfinite(after).all()
    np.testing.assert_array_equal(after, before)


@pytest.mark.parametrize("layer", [0, 2])
def test_jax_new_h_ignores_padded_destination_columns(setup, layer):
    s = setup
    before = _jax_new_h(s, layer, s["inp"]["hb"])
    after = _jax_new_h(s, layer, s["filled"])
    assert np.isfinite(after).all()
    np.testing.assert_array_equal(after, before)


def test_port_matches_jax_on_filled_columns(setup):
    s = setup
    np.testing.assert_allclose(_port_new_h(s, 1, s["filled"]),
                               _jax_new_h(s, 1, s["filled"]), **TOL)


def test_filled_columns_do_reach_a_valid_destination(setup):
    """The same fill in a valid destination's column moves its new_h: the
    column is read, and only a padded destination's pool voids it."""
    s = setup
    hb = s["inp"]["hb"].copy()
    b, dl = s["padded"][0]
    valid = next(i for i in range(C.NL) if s["inp"]["node_mask"][b, C.NP + i])
    hb[b, :, valid, :] = s["filled"][b, :, dl, :]
    before = _port_new_h(s, 0, s["inp"]["hb"])
    after = _port_new_h(s, 0, hb)
    assert not np.array_equal(after[b, C.NP + valid], before[b, C.NP + valid])
