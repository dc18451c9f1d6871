"""The port's flax msgpack reader and writer (no flax, no msgpack), the
weight map onto the port's modules and back, and training checkpoints
crossing between the two packages both ways."""
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
    assert pg.config.model.denoiser.fused_stack == "none"  # the checkpoint's
    sd = pg.net.state_dict()
    tree, _ = ck.load_release(RELEASE)
    flat = ck.flatten_tree(tree)
    assert set(sd) == set(flat)
    k = "denoiser.layers.layer.bond_layer.tf_q.Dense_1.kernel"
    np.testing.assert_array_equal(sd[k].numpy(), flat[k])


def test_writer_is_read_back_by_flax_leaf_for_leaf():
    tree = {"params": {"a": {"kernel": np.arange(6, dtype=np.float32
                                                 ).reshape(2, 3)},
                       "frozen": {}},
            "step": np.asarray(5, np.int32), "flag": np.bool_(True),
            "big": np.zeros((300, 300), np.float32), "name": "s" * 300,
            "none": None, "ratio": 1.5, "neg": -3, "wide": 70000}
    raw = ck.msgpack_serialize(tree)
    for restore in (serialization.msgpack_restore, ck.msgpack_restore):
        back = restore(raw)
        flat, ref = ck.flatten_tree(back), ck.flatten_tree(tree)
        assert flat.keys() == ref.keys()
        for k, v in ref.items():
            if isinstance(v, (np.ndarray, np.generic)):
                got = np.asarray(flat[k])
                assert got.dtype == v.dtype and got.shape == v.shape, k
                np.testing.assert_array_equal(got, v)
            else:
                assert flat[k] == v, k
    with open(RELEASE + ".msgpack", "rb") as f:
        release = f.read()
    # the release checkpoint survives read -> write -> flax read bit for bit
    again = serialization.msgpack_restore(
        ck.msgpack_serialize(ck.msgpack_restore(release)))
    ref = ck.flatten_tree(serialization.msgpack_restore(release))
    for k, a in ck.flatten_tree(again).items():
        assert a.tobytes() == ref[k].tobytes(), k


def test_to_jax_params_inverts_from_jax_params():
    tree, _ = ck.load_release(RELEASE)
    back = ck.to_jax_params(ck.from_jax_params(tree))
    flat, ref = ck.flatten_tree(back), ck.flatten_tree(tree)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k])


def _tiny_port_state(freeze=False, opt="adam"):
    import torch
    from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params
    from phoregen_tpu_torch.train.state import create_train_state
    from test_torch_port_model import port_config, small_config
    jcfg = small_config("xla")
    jcfg.model.denoiser.num_layers = 2
    jcfg.train.freeze_pos = freeze
    jcfg.train.optimizer.type = opt
    cfg = port_config(jcfg, "pallas2")
    pg = PhoreGen(cfg)
    init_params(pg.net, 3)
    st = create_train_state(cfg.train, pg.net)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):           # two optimizer steps on made-up gradients
        for p in pg.net.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        st.optimizer.step()
        st.grad_queue.push(torch.tensor(12.5))
        st.step += 1
    for v in st.ema_params.values():
        v.mul_(0.5)
    return jcfg, cfg, pg, st


@pytest.mark.parametrize("freeze,opt", [(False, "adam"), (False, "adamw"),
                                        (True, "adam")])
def test_port_checkpoint_loads_in_the_jax_package(tmp_path, freeze, opt):
    """What the port's trainer writes, the JAX package reads: the whole
    TrainState through `load_checkpoint` (so the optimizer state has
    optax's structure, masked nodes included) and the parameters through
    `load_params_only`; and the port's own sample path loads it."""
    import jax
    from phoregen_tpu.data.loader import PhoreDataLoader
    from phoregen_tpu.data.synthetic import synthetic_dataset
    from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
    from phoregen_tpu.train import checkpoint as jck
    from phoregen_tpu.train.state import (create_train_state,
                                          get_learning_rate)
    from phoregen_tpu_torch.models.phoregen import load_release_model
    from phoregen_tpu_torch.train import checkpoint as pck
    jcfg, cfg, pg, st = _tiny_port_state(freeze, opt)
    prefix = str(tmp_path / "last_model")
    pck.save_checkpoint(prefix, st, 4, cfg, {"scheduler": {"lr": 1e-4}})
    with open(prefix + ".msgpack", "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    named = dict(pg.net.named_parameters())
    for key, mine in (("params", named), ("ema_params", st.ema_params)):
        flat = ck.flatten_tree(tree[key]["params"])
        assert set(flat) == set(mine)
        for k, v in flat.items():
            np.testing.assert_array_equal(v, mine[k].detach().numpy())
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = JPhoreGen(jcfg)
    template = jpg.init_params(jax.random.PRNGKey(0), batch)
    params = jck.load_params_only(prefix, template)
    k = "denoiser.layers.layer.lin_node.kernel"
    np.testing.assert_array_equal(
        np.asarray(ck.flatten_tree(params["params"])[k]),
        named[k].detach().numpy())
    jst, meta = jck.load_checkpoint(
        prefix, create_train_state(jcfg.train, template))
    assert meta["epoch"] == 4 and int(jst.step) == 2
    assert int(jst.grad_queue.count) == 3
    assert get_learning_rate(jst.opt_state) == pytest.approx(
        cfg.train.optimizer.lr)
    adam = pck.find_adam_state(serialization.to_state_dict(jst.opt_state))
    assert int(adam["count"]) == 2
    mu = {k: v for k, v in ck.flatten_tree(adam["mu"]["params"]).items()
          if not isinstance(v, dict)}
    assert (k in mu) and all(("pos_layer" in n) != (n in mu) or not freeze
                             for n in named)
    np.testing.assert_array_equal(
        np.asarray(mu[k]), st.optimizer.state[named[k]]["exp_avg"].numpy())
    # release form, and the port's own sampling entry point
    rel = str(tmp_path / "release")
    pck.save_release(rel, st, cfg, use_ema=True)
    pg2, meta2 = load_release_model(rel, device="cpu")
    assert meta2["release"] is True and meta2["ema"] is True
    np.testing.assert_array_equal(
        dict(pg2.net.named_parameters())[k].detach().numpy(),
        st.ema_params[k].numpy())
    pg3, _ = load_release_model(prefix, device="cpu")
    np.testing.assert_array_equal(
        dict(pg3.net.named_parameters())[k].detach().numpy(),
        named[k].detach().numpy())


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """What the JAX package's `save_checkpoint` writes, the port reads:
    params, EMA, Adam moments, queue, step and lr."""
    import jax
    import jax.numpy as jnp
    from phoregen_tpu.data.loader import PhoreDataLoader
    from phoregen_tpu.data.synthetic import synthetic_dataset
    from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
    from phoregen_tpu.train import checkpoint as jck
    from phoregen_tpu.train import state as jstate
    from phoregen_tpu_torch.train import checkpoint as pck
    jcfg, cfg, pg, st = _tiny_port_state()
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(1), batch)
    jst = jstate.create_train_state(jcfg.train, params)
    tx = jstate.make_optimizer(jcfg.train)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * jnp.ones_like(p) + p,
                                   params)
    _, opt_state = tx.update(grads, jst.opt_state, params)
    jst = jst.replace(
        opt_state=jstate.set_learning_rate(opt_state, 3e-5),
        ema_params=jax.tree_util.tree_map(lambda p: 0.5 * p, params),
        grad_queue=jst.grad_queue.push(jnp.asarray(40.0)),
        step=jnp.asarray(9, jnp.int32))
    prefix = str(tmp_path / "last_model")
    jck.save_checkpoint(prefix, jst, 3, jcfg.to_dict())
    st, meta = pck.load_checkpoint(prefix, st)
    assert meta["epoch"] == 3 and st.step == 9
    assert (st.grad_queue.count, st.grad_queue.head) == (2, 2)
    assert float(st.grad_queue.values[1]) == 40.0
    assert st.optimizer.param_groups[0]["lr"] == pytest.approx(3e-5)
    named = dict(pg.net.named_parameters())
    ref_p = ck.flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                   params["params"]))
    adam = pck.find_adam_state(serialization.to_state_dict(jst.opt_state))
    ref_mu = ck.flatten_tree(adam["mu"]["params"])
    ref_nu = ck.flatten_tree(adam["nu"]["params"])
    assert set(named) == set(ref_p)
    for k, p in named.items():
        np.testing.assert_array_equal(p.detach().numpy(), ref_p[k])
        np.testing.assert_array_equal(st.ema_params[k].numpy(),
                                      0.5 * ref_p[k])
        s = st.optimizer.state[p]
        assert float(s["step"]) == 1.0
        np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                      np.asarray(ref_mu[k]))
        np.testing.assert_array_equal(s["exp_avg_sq"].numpy(),
                                      np.asarray(ref_nu[k]))
