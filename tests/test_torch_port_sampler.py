"""The port's reverse step and generation pipeline against the JAX
package's components, on the same weights and the same injected draws.

One step is checked piece by piece: the network's predictions (JAX
`fused_stack='xla'`), the categorical posteriors (`q_v_posterior_mats` on
the JAX package's strided tables), Gumbel-max sampling on the same
uniforms, and the Gaussian posterior mean with the guidance gradient
(`jax.grad` of the JAX energies, `get_prev_with`). Posterior tolerance
1e-5 (float32 on identical inputs); predictions 2e-4 as in
tests/test_torch_port_model.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.ops.masked import masked_mean as jmasked_mean
from phoregen_tpu.sample import sampler as jsampler

from phoregen_tpu_torch.data.batching import replicate_phore
from phoregen_tpu_torch.data.phore import parse_phore_text
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.sample import sampler as psampler
from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
from phoregen_tpu_torch.sample.reconstruct import \
    reconstruct_from_generated_with_edges
from phoregen_tpu_torch.utils.checkpoint import from_jax_params

from test_torch_port_model import port_config, small_config

PHORE_TEXT = """pipe_phore
AR\t1.0\t1\t1\t1.0\t2.0\t3.0\t1\t0.0\t0.0\t1.0\t0\t1
HD\t0.7\t1\t1\t-1.0\t0.5\t2.0\t0\t0.0\t0.0\t0.0\t0\t1
HY\t1.0\t1\t1\t0.5\t-1.0\t1.0\t0\t0.0\t0.0\t0.0\t0\t1
EX\t0.837\t0.5\t1\t4.0\t4.0\t4.0\t0\t0.0\t0.0\t0.0\t0\t1
$$$$
"""
GUIDANCE = [dict(type="atom_prox", min_d=1.0, max_d=3.0),
            dict(type="center_prox")]


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
    return jpg, params, pg


def _sampling_batch(pg, counts=(5, 9, 12)):
    pipe = GenerationPipeline(pg, device="cpu")
    sample = pipe.prepare_phore(parse_phore_text(PHORE_TEXT, "pipe_phore"))
    return replicate_phore(sample, len(counts), np.asarray(counts), 16)


def test_one_reverse_step_matches_jax(models):
    jpg, params, pg = models
    hb = _sampling_batch(pg)
    batch = hb.to("cpu")
    sp = psampler.Sampler(pg, [psampler.GuidanceOpt(**g) for g in GUIDANCE])
    inv = sp.prepare(batch)
    gen = torch.Generator().manual_seed(0)
    state = sp.init_state(batch, gen)
    B, NL = batch.lig_mask.shape
    rng = np.random.default_rng(7)
    draws = {"node_u": torch.from_numpy(rng.uniform(size=(B, NL, 12))
                                        .astype(np.float32)),
             "edge_u": torch.from_numpy(rng.uniform(size=(B, NL, NL, 6))
                                        .astype(np.float32)),
             "pos_noise": torch.from_numpy(rng.normal(size=(B, NL, 3))
                                           .astype(np.float32))}
    i = 2
    new, (pn, pp, pe) = sp.step(state, i, batch, inv, False, draws=draws)

    # network predictions
    J = lambda a: jnp.asarray(a.numpy())
    ts, node_tabs, edge_tabs, gauss = jsampler.Sampler(jpg)._build_schedule(
        8, 8)
    t = jnp.full((B,), int(ts[i]), jnp.int32)
    oh = jax.nn.one_hot
    ref = jpg.net.apply(params, oh(J(state["node"]), 12), J(state["pos"]),
                        J(batch.lig_mask), oh(J(state["edge"]), 6), t,
                        J(batch.phore_x), J(batch.phore_pos),
                        J(batch.phore_norm), J(batch.phore_mask))
    lm = hb.lig_mask
    bm = lm[:, :, None] & lm[:, None, :]
    np.testing.assert_allclose(pn.numpy()[lm], np.asarray(ref[0])[lm],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(pp.numpy()[lm], np.asarray(ref[1])[lm],
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(pe.numpy()[bm], np.asarray(ref[2])[bm],
                               atol=2e-4, rtol=2e-4)

    # categorical posteriors on the port's predictions
    log_node = jpg.node_transition.q_v_posterior_mats(
        jax.nn.log_softmax(J(pn), -1), J(state["log_node"]),
        node_tabs[0][i], node_tabs[1][i], False)
    log_edge = jpg.edge_transition.q_v_posterior_mats(
        jax.nn.log_softmax(J(pe), -1), J(state["log_edge"]),
        edge_tabs[0][i], edge_tabs[1][i], False)
    np.testing.assert_allclose(new["log_node"].numpy(), np.asarray(log_node),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(new["log_edge"].numpy(), np.asarray(log_edge),
                               atol=1e-5, rtol=1e-5)

    # Gumbel-max on the same uniforms (the JAX package's formula)
    def gumbel_argmax(logits, u):
        g = -jnp.log(-jnp.log(J(u) + 1e-30) + 1e-30)
        return np.asarray(jnp.argmax(g + logits, -1))
    np.testing.assert_array_equal(new["node"].numpy(),
                                  gumbel_argmax(log_node, draws["node_u"]))
    np.testing.assert_array_equal(new["edge"].numpy(),
                                  gumbel_argmax(log_edge, draws["edge_u"]))

    # guidance gradient and the Gaussian posterior mean
    lig_mask = J(batch.lig_mask)
    bond_mask = lig_mask[:, :, None] & lig_mask[:, None, :] \
        & ~jnp.eye(NL, dtype=bool)
    p_mask = (J(batch.phore_x)[..., jpg.ex_col] != 1) & J(batch.phore_mask)
    center = jmasked_mean(J(batch.phore_pos), p_mask[..., None], axis=1)
    h_edge = oh(J(new["edge"]), 6)

    def energy(p):
        return (jsampler.atom_prox_energy(p, h_edge, bond_mask, lig_mask,
                                          1.0, 3.0)
                + jsampler.center_prox_energy(p, lig_mask, center))
    grad = jax.grad(energy)(J(state["pos"]))
    mu = jpg.pos_transition.get_prev_with(
        jax.random.PRNGKey(0), J(state["pos"]), J(pp), gauss[0][i],
        gauss[1][i], gauss[2][i], True, energy_grad=grad)
    port_mu = new["pos"] - float(gauss[2][i]) * draws["pos_noise"]
    np.testing.assert_allclose(port_mu.numpy(), np.asarray(mu), atol=1e-5,
                               rtol=1e-5)


def test_schedule_tables_match_jax(models):
    jpg, _, pg = models
    ts, node, edge, gauss = psampler.Sampler(pg, sample_steps=4).schedule()
    jts, jnode, jedge, jgauss = jsampler.Sampler(
        jpg, sample_steps=4)._build_schedule(4, 8)
    np.testing.assert_array_equal(ts, np.asarray(jts))
    S = len(ts)
    for a, b in zip(node + edge, jnode + jedge):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:S - 1])
    for a, b in zip(gauss, jgauss):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_energies_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(2, 5, 3)).astype(np.float32) * 2
    lig = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], bool)
    bond = lig[:, :, None] & lig[:, None, :] & ~np.eye(5, dtype=bool)
    ids = rng.integers(0, 6, size=(2, 5, 5))
    center = rng.normal(size=(2, 3)).astype(np.float32)
    T = torch.from_numpy
    e = psampler.atom_prox_energy(
        T(pos), torch.nn.functional.one_hot(T(ids), 6), T(bond), T(lig),
        1.0, 3.0) + psampler.center_prox_energy(T(pos), T(lig), T(center))
    je = jsampler.atom_prox_energy(
        jnp.asarray(pos), jax.nn.one_hot(ids, 6), jnp.asarray(bond),
        jnp.asarray(lig), 1.0, 3.0) + jsampler.center_prox_energy(
        jnp.asarray(pos), jnp.asarray(lig), jnp.asarray(center))
    assert float(e) == pytest.approx(float(je), abs=1e-5)


@pytest.mark.parametrize("mode", ["uniform", "normal"])
def test_sample_counts_bounds(mode):
    c = psampler.Sampler.sample_counts(np.random.default_rng(0), 10, 20, 64,
                                       mode=mode, scale=6.0)
    assert c.shape == (64,) and c.min() >= 10 and c.max() <= 20


def test_pipeline_end_to_end_writes_sdf(models, tmp_path):
    """Phore file -> count interval -> T=8 reverse loop -> decode ->
    SDF/SMILES on the CPU. The weights are random, so the valence check is
    relaxed here to exercise the writers."""
    _, _, pg = models
    pipe = GenerationPipeline(
        pg, guidance=[psampler.GuidanceOpt(**g) for g in GUIDANCE],
        sample_nodes_mode="normal", normal_scale=6.0, batch_size=2, seed=5,
        device="cpu")

    def lenient(info):
        mol = reconstruct_from_generated_with_edges(
            info, add_edge="predicted", check_validity=False)
        return mol, mol.formula()
    pipe.reconstruct = lenient
    out_dir = str(tmp_path / "gen")
    res = pipe.generate(parse_phore_text(PHORE_TEXT, "pipe_phore"),
                        num_samples=2, out_dir=out_dir)
    lo, up = res["count_interval"]
    assert 4 <= lo <= up <= 78
    mol_dir = os.path.join(out_dir, "pipe_phore")
    sdfs = sorted(f for f in os.listdir(mol_dir) if f.endswith(".sdf"))
    assert len(sdfs) == res["n_finished"] == 2
    with open(os.path.join(mol_dir, sdfs[0])) as f:
        text = f.read()
    assert "V2000" in text and text.rstrip().endswith("$$$$")
    assert os.path.exists(os.path.join(out_dir, "time_chain.txt"))
