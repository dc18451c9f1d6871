"""The port's per-layer module path (`fused_stack='none'`) against the JAX
package's, whole network, on the same weights (through `from_jax_params`)
and the same inputs: hidden 32, 4 heads, 2 layers, kNN 4, triplet width 8,
3 graphs in the 16-slot ligand bucket with 16 phore slots.

Tolerance atol = rtol = 1e-4: two layers of LayerNorm'd float32 attention
whose sums run in another order. Compared on valid ligand slots (padded
slots are inert; their kNN rows hold ties among masked sources)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.config import default_config
from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.utils.checkpoint import from_jax_params

TOL = dict(atol=1e-4, rtol=1e-4)


def module_config(**denoiser):
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 32
    m.denoiser.num_layers = 2
    m.denoiser.n_heads = 4
    m.denoiser.knn = 4
    m.denoiser.triplet_knn = 3
    m.denoiser.triplet_width = 8
    m.denoiser.fused_stack = "none"
    for k, v in denoiser.items():
        setattr(m.denoiser, k, v)
    m.diff.num_timesteps = 8
    m.diff.time_dim = 2
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.dataset.corpus = "chains"
    return cfg.finalize()


def _batch(jcfg):
    return next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                     jcfg, 3, shuffle=False)))


def _inputs(batch, seed=5):
    B, NL = batch.lig_type.shape
    rng = np.random.default_rng(seed)
    return dict(
        h_node=rng.normal(size=(B, NL, 12)).astype(np.float32),
        h_edge=rng.normal(size=(B, NL, NL, 6)).astype(np.float32),
        pos=(np.asarray(batch.lig_pos)
             + 0.1 * rng.normal(size=batch.lig_pos.shape)).astype(np.float32),
        t=rng.integers(0, 8, size=(B,)).astype(np.int32))


def _port_net(jcfg, params, **denoiser):
    cfg = config_from_dict(jcfg.to_dict())
    for k, v in denoiser.items():
        setattr(cfg.model.denoiser, k, v)
    pg = PhoreGen(cfg)
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    return pg.net.eval()


def _port_forward(net, batch, x):
    tb = PhoreGraphBatch(**{k: np.array(v) for k, v in
                            vars(batch).items()}).to("cpu")
    T = torch.from_numpy
    with torch.no_grad():
        return net(T(x["h_node"]), T(x["pos"]), tb.lig_mask, T(x["h_edge"]),
                   T(x["t"]), tb.phore_x, tb.phore_pos, tb.phore_norm,
                   tb.phore_mask)


def _jax_forward(jcfg, params, batch, x):
    return JPhoreGen(jcfg).net.apply(
        params, jnp.asarray(x["h_node"]), jnp.asarray(x["pos"]),
        batch.lig_mask, jnp.asarray(x["h_edge"]), jnp.asarray(x["t"]),
        batch.phore_x, batch.phore_pos, batch.phore_norm, batch.phore_mask)


def _assert_same(out, ref, batch, tol=TOL):
    lm = np.asarray(batch.lig_mask)
    bm = lm[:, :, None] & lm[:, None, :]
    for a, b, m in zip(out[:3], ref[:3], (lm, lm, bm)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a[m]).all()
        np.testing.assert_allclose(a[m], b[m], **tol)
    for a, b in zip(out[3], ref[3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def stacked():
    """One stacked (`scan_layers`) parameter set; every variant below
    changes how the stack runs, not its parameters."""
    jcfg = module_config()
    batch = _batch(jcfg)
    params = JPhoreGen(jcfg).init_params(jax.random.PRNGKey(0), batch)
    return params, batch


VARIANTS = {
    "knn3": dict(triplet_knn=3),
    "knn3_freeze": dict(triplet_knn=3, block_knn_freeze=True),
    "allk": dict(triplet_knn=0),
    "allk_freeze": dict(triplet_knn=0, block_knn_freeze=True),
    "allk_use_pallas_triplet": dict(triplet_knn=0, use_pallas_triplet=True),
    "concat": dict(edge_mlp_apply="concat"),
    "radius": dict(cutoff_mode="radius", r_max=2.5),
    "hybrid": dict(cutoff_mode="hybrid"),
    "two_blocks": dict(num_blocks=2),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_module_path_forward_matches_jax(stacked, variant):
    params, batch = stacked
    jcfg = module_config(**VARIANTS[variant])
    x = _inputs(batch)
    ref = _jax_forward(jcfg, params, batch, x)
    out = _port_forward(_port_net(jcfg, params), batch, x)
    _assert_same([o.numpy() if o is not None else o for o in out[:3]]
                 + [[c.numpy() for c in out[3]]], ref, batch)


@pytest.mark.parametrize("fused", ["pallas", "xla", "xla2"])
def test_frozen_module_path_matches_port_fused_stack(stacked, fused):
    """With the kNN sets frozen per block the module path and the fused
    stack are the same computation (two LayerNorm forms, other summation
    order): 1e-4."""
    params, batch = stacked
    jcfg = module_config(block_knn_freeze=True)
    x = _inputs(batch, seed=7)
    mod = _port_forward(_port_net(jcfg, params), batch, x)
    fus = _port_forward(_port_net(jcfg, params, fused_stack=fused), batch, x)
    _assert_same([o.numpy() for o in fus[:3]] + [[c.numpy() for c in fus[3]]],
                 [o.numpy() for o in mod[:3]] + [[c.numpy() for c in mod[3]]],
                 batch)


def test_port_xla_stack_matches_jax_xla(stacked):
    params, batch = stacked
    jcfg = module_config(fused_stack="xla")
    x = _inputs(batch)
    ref = _jax_forward(jcfg, params, batch, x)
    out = _port_forward(_port_net(jcfg, params), batch, x)
    _assert_same([o.numpy() for o in out[:3]]
                 + [[c.numpy() for c in out[3]]], ref, batch,
                 dict(atol=2e-4, rtol=2e-4))   # as tests/test_torch_port_model.py


def test_module_path_packs_nothing(stacked):
    params, batch = stacked
    net = _port_net(module_config(), params)
    assert net.pack_fused() is None
    assert len(net.denoiser.layer_trees()) == 2
