"""The port's flax msgpack reader (no flax, no msgpack) and the weight map
onto the port's modules."""
import os

import numpy as np
import pytest
from flax import serialization

from phoregen_tpu_torch.utils import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = os.path.join(REPO, "release", "flagship_r4")


def test_reader_bit_equal_to_flax_on_release():
    with open(RELEASE + ".msgpack", "rb") as f:
        raw = f.read()
    ours = ck.flatten_tree(ck.msgpack_restore(raw))
    ref = ck.flatten_tree(serialization.msgpack_restore(raw))
    assert ours.keys() == ref.keys()
    for k, a in ours.items():
        b = ref[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("value", [
    {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
     "b": {"c": np.int32(7), "d": np.zeros((0,), np.float64)}},
    {"x": [1, -3, 300, -70000, 2 ** 40, 1.5, "s" * 40, None, True]},
])
def test_reader_round_trips_flax_bytes(value):
    raw = serialization.msgpack_serialize(value)
    ours = ck.msgpack_restore(raw)
    ref = serialization.msgpack_restore(raw)
    flat_o, flat_r = ck.flatten_tree(ours), ck.flatten_tree(ref)
    assert flat_o.keys() == flat_r.keys()
    for k in flat_o:
        np.testing.assert_array_equal(np.asarray(flat_o[k], dtype=object),
                                      np.asarray(flat_r[k], dtype=object))


def test_release_loads_strictly_into_the_port():
    from phoregen_tpu_torch.models.phoregen import load_release_model
    pg, meta = load_release_model(RELEASE, device="cpu")
    assert meta["step"] == 6000
    assert pg.config.model.denoiser.fused_stack == "pallas"
    sd = pg.net.state_dict()
    tree, _ = ck.load_release(RELEASE)
    flat = ck.flatten_tree(tree)
    assert set(sd) == set(flat)
    k = "denoiser.layers.layer.bond_layer.tf_q.Dense_1.kernel"
    np.testing.assert_array_equal(sd[k].numpy(), flat[k])
