"""The port's PhoreDiffNet (fused stack, plain stage versions on the CPU)
against the JAX package's PhoreDiffNet with `fused_stack='xla'` — the
oracle of its Pallas path — on the same weights (passed through
`from_jax_params`) and the same inputs.

Tolerance atol = rtol = 2e-4, the JAX package's own fused-vs-oracle
tolerance: the outputs sit behind 3 layers of LayerNorm'd attention and
the triplet angle differs by up to ~1e-5 rad (polynomial atan2 in JAX)."""
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

TOL = dict(atol=2e-4, rtol=2e-4)


def small_config(fused: str, trip_k: int = 3):
    """The small stack of tests/test_layer_stack.py::_setup."""
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 16
    m.denoiser.num_layers = 3
    m.denoiser.n_heads = 2
    m.denoiser.knn = 4
    m.denoiser.triplet_knn = trip_k
    m.denoiser.triplet_width = 8
    m.denoiser.fused_stack = fused
    m.diff.num_timesteps = 8
    m.diff.time_dim = 2
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.dataset.corpus = "chains"
    return cfg.finalize()


def port_config(jcfg, fused="pallas"):
    cfg = config_from_dict(jcfg.to_dict())
    cfg.model.denoiser.fused_stack = fused
    return cfg


@pytest.fixture(scope="module")
def models():
    jcfg = small_config("xla")
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    pg = PhoreGen(port_config(jcfg))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    pg.net.eval()
    return jpg, params, pg, batch


def _inputs(batch, seed=5):
    B, NL = batch.lig_type.shape
    rng = np.random.default_rng(seed)
    return dict(
        h_node=rng.normal(size=(B, NL, 12)).astype(np.float32),
        h_edge=rng.normal(size=(B, NL, NL, 6)).astype(np.float32),
        pos=(np.asarray(batch.lig_pos)
             + 0.1 * rng.normal(size=batch.lig_pos.shape)).astype(np.float32),
        t=rng.integers(0, 8, size=(B,)).astype(np.int32))


def test_forward_matches_jax_fused_xla(models):
    jpg, params, pg, batch = models
    x = _inputs(batch)
    ref = jpg.net.apply(params, jnp.asarray(x["h_node"]),
                        jnp.asarray(x["pos"]), batch.lig_mask,
                        jnp.asarray(x["h_edge"]), jnp.asarray(x["t"]),
                        batch.phore_x, batch.phore_pos, batch.phore_norm,
                        batch.phore_mask)
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    T = torch.from_numpy
    with torch.no_grad():
        out = pg.net(T(x["h_node"]), T(x["pos"]), tb.lig_mask,
                     T(x["h_edge"]), T(x["t"]), tb.phore_x, tb.phore_pos,
                     tb.phore_norm, tb.phore_mask)
    lm = np.asarray(batch.lig_mask)
    bm = lm[:, :, None] & lm[:, None, :]
    # padded slots are inert (their kNN sets follow top-k tie order)
    np.testing.assert_allclose(out[0].numpy()[lm], np.asarray(ref[0])[lm],
                               **TOL)
    np.testing.assert_allclose(out[1].numpy()[lm], np.asarray(ref[1])[lm],
                               **TOL)
    np.testing.assert_allclose(out[2].numpy()[bm], np.asarray(ref[2])[bm],
                               **TOL)
    for a, b in zip(out[3], ref[3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_count_interval_matches_jax(models):
    jpg, params, pg, batch = models
    lo, up = jpg.net.apply(params, batch.phore_x, batch.phore_pos,
                           batch.phore_norm, batch.phore_mask,
                           method="count_interval")
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    with torch.no_grad():
        plo, pup = pg.net.count_interval(tb.phore_x, tb.phore_pos,
                                         tb.phore_norm, tb.phore_mask)
    np.testing.assert_allclose(plo.numpy(), np.asarray(lo), **TOL)
    np.testing.assert_allclose(pup.numpy(), np.asarray(up), **TOL)


@pytest.mark.parametrize("fused", ["none", "xla", "xla2", "pallas3",
                                   "pallas2"])
def test_unported_fused_stacks_raise(fused):
    """No `fused_stack` value is left unported: 'pallas3' / 'pallas2' (the
    merged stage kernels) build like 'none', 'xla' and 'xla2', each with
    float32 or bf16 inter-stage blocks (these used to raise); an unknown
    value of either still raises."""
    cfg = port_config(small_config("xla"), fused)
    assert PhoreGen(cfg).net.denoiser.fused_stack == fused
    cfg.model.denoiser.fused_block_dtype = "bfloat16"
    assert PhoreGen(cfg).net.denoiser.block_dtype == torch.bfloat16
    cfg.model.denoiser.fused_block_dtype = "float16"
    with pytest.raises(ValueError, match="fused_block_dtype"):
        PhoreGen(cfg)
    cfg.model.denoiser.fused_block_dtype = "float32"
    cfg.model.denoiser.fused_stack = fused + "_"
    with pytest.raises(ValueError, match="unknown fused_stack"):
        PhoreGen(cfg)


def test_fused_stack_requires_flagship_config():
    cfg = port_config(small_config("xla"))
    cfg.model.denoiser.direction_match = False
    with pytest.raises(ValueError, match="flagship"):
        PhoreGen(cfg)
