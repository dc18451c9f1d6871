"""The port's reverse step and generation pipeline against the JAX
package's components, on the same weights and the same injected draws.

One step is checked piece by piece: the network's predictions (JAX
`fused_stack='xla'`), the categorical posteriors (`q_v_posterior_mats` on
the JAX package's strided tables), Gumbel-max sampling on the same
uniforms, and the Gaussian posterior mean with the guidance gradient
(`jax.grad` of the JAX energies, `get_prev_with`). Posterior tolerance
1e-5 (float32 on identical inputs); predictions 2e-4 as in
tests/test_torch_port_model.py."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.phore import parse_phore_file as jparse_phore_file
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.ops.masked import masked_mean as jmasked_mean
from phoregen_tpu.sample import sampler as jsampler

from phoregen_tpu_torch.data.batching import replicate_phore
from phoregen_tpu_torch.data.phore import parse_phore_file, parse_phore_text
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


def _lenient(info):
    """Reconstruction without the valence check: the weights are random."""
    mol = reconstruct_from_generated_with_edges(
        info, add_edge="predicted", check_validity=False)
    return mol, mol.formula()


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


@pytest.fixture(scope="module")
def module_models():
    """The same small network on the per-layer module path
    (`fused_stack='none'`, exact all-k triplets) in both packages."""
    jcfg = small_config("none", trip_k=0)
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    pg = PhoreGen(port_config(jcfg, "none"))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    pg.net.eval()
    return jpg, params, pg


def test_one_reverse_step_matches_jax(models):
    _check_one_reverse_step(*models)


def test_one_reverse_step_matches_jax_module_path(module_models):
    jpg, params, pg = module_models
    assert pg.net.pack_fused() is None
    _check_one_reverse_step(jpg, params, pg)


def test_one_reverse_step_matches_step_core(module_models):
    """The JAX sampler's own `step_core` on the same state: its network
    predictions (2e-4, as above) and categorical posteriors (its draws come
    from a JAX key, so sampled ids are not compared). The posteriors are
    log-probabilities of each package's own predictions, where a 2e-4
    logit difference grows in the low-probability classes: 2e-3."""
    jpg, params, pg = module_models
    hb = _sampling_batch(pg)
    batch = hb.to("cpu")
    sp = psampler.Sampler(pg, [psampler.GuidanceOpt(**g) for g in GUIDANCE])
    state = sp.init_state(batch, torch.Generator().manual_seed(1))
    i = 3
    new, (pn, pp, pe) = sp.step(state, i, batch, sp.prepare(batch), False,
                                torch.Generator().manual_seed(2))
    from phoregen_tpu.data.batching import PhoreGraphBatch as JBatch
    jb = JBatch(**{k: jnp.asarray(np.asarray(v)) for k, v in
                   vars(hb).items()})
    step_core, _, S = jsampler.Sampler(
        jpg, [jsampler.GuidanceOpt(**g) for g in GUIDANCE])._reverse_parts(
        params, jb)
    J = lambda a: jnp.asarray(a.numpy())
    carry = (jax.random.PRNGKey(0), J(state["pos"]),
             J(state["node"]).astype(jnp.int8), J(state["log_node"]),
             J(state["edge"]).astype(jnp.int8), J(state["log_edge"]))
    jcarry, jpreds = step_core(carry, i, is_final=False)
    assert S == 8
    lm = hb.lig_mask
    bm = lm[:, :, None] & lm[:, None, :]
    for got, want, m in zip((pn, pp, pe), jpreds, (lm, lm, bm)):
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(new["log_node"].numpy()[lm],
                               np.asarray(jcarry[3])[lm], atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(new["log_edge"].numpy()[bm],
                               np.asarray(jcarry[5])[bm], atol=2e-3,
                               rtol=2e-3)


def _check_one_reverse_step(jpg, params, pg):
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


def test_frag_attract_energy_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(2, 7, 3)).astype(np.float32)
    pos[0, 4:] += 6.0                       # graph 0 splits into two clusters
    lig = np.ones((2, 7), bool)
    lig[1, 5:] = False
    p = torch.from_numpy(pos).requires_grad_(True)
    e = psampler.frag_attract_energy(p, torch.from_numpy(lig), 1.2, 2.0)
    g, = torch.autograd.grad(e, p)
    je, jg = jax.value_and_grad(
        lambda q: jsampler.frag_attract_energy(q, jnp.asarray(lig), 1.2,
                                               2.0))(jnp.asarray(pos))
    assert e.item() > 0.1
    assert e.item() == pytest.approx(float(je), abs=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-4)


def test_unknown_guidance_raises(models):
    with pytest.raises(ValueError, match="frag_attract"):
        psampler.Sampler(models[2], [psampler.GuidanceOpt(type="magnet")])


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


def test_generate_from_file_is_generate_on_the_parsed_phore(models, tmp_path):
    """`generate_from_file` returns the dict and writes the SDF and SMILES
    files that `generate` does on the parsed phore, on the same seed; the
    port parses the file into the JAX package's Phore."""
    _, _, pg = models
    path = str(tmp_path / "pipe_phore.phore")
    with open(path, "w") as f:
        f.write(PHORE_TEXT)
    phore = parse_phore_file(path)
    assert dataclasses.asdict(phore) == dataclasses.asdict(
        jparse_phore_file(path))

    def run(tag):
        pipe = GenerationPipeline(
            pg, guidance=[psampler.GuidanceOpt(**g) for g in GUIDANCE],
            batch_size=2, seed=5, device="cpu")
        pipe.reconstruct = _lenient
        out = str(tmp_path / tag)
        res = (pipe.generate_from_file(path, 2, out) if tag == "file"
               else pipe.generate(phore, 2, out))
        files = {}
        for d, _, names in os.walk(out):
            for n in names:
                with open(os.path.join(d, n)) as f:
                    files[os.path.relpath(os.path.join(d, n), out)] = f.read()
        return res, files

    (a, fa), (b, fb) = run("file"), run("parsed")
    assert a.keys() == b.keys()
    for k in a:
        if k not in ("mols", "seconds"):
            assert a[k] == b[k], k
    assert a["name"] == "pipe_phore" and a["n_finished"] == 2
    assert fa.keys() == fb.keys()
    assert {"pipe_phore/0.sdf", "pipe_phore/1.sdf",
            "pipe_phore/pipe_phore_smiles.txt"} <= fa.keys()
    for name in fa:
        if name != "time_chain.txt":          # it holds the seconds
            assert fa[name] == fb[name], name


def test_pipeline_keeps_and_writes_trajectories(module_models, tmp_path):
    """keep_traj on the module path: the sampler returns the prior draw and
    every step's state, the pipeline writes them as a multi-record SDF."""
    _, _, pg = module_models
    pipe = GenerationPipeline(
        pg, guidance=[psampler.GuidanceOpt(type="frag_attract")],
        batch_size=2, keep_traj=True, seed=3, device="cpu")

    def lenient(info):
        mol = reconstruct_from_generated_with_edges(
            info, add_edge="predicted", check_validity=False)
        return mol, mol.formula()
    pipe.reconstruct = lenient
    phore = parse_phore_text(PHORE_TEXT, "pipe_phore")
    sample = pipe.prepare_phore(phore)
    _, raw = pipe.sample_pool(sample, 2, 6, 9)
    T1 = pg.num_timesteps + 1
    assert tuple(raw["traj"]["pos"].shape) == (T1, 2, 16, 3)
    assert tuple(raw["traj"]["edge"].shape) == (T1, 2, 16, 16)
    assert torch.equal(raw["traj"]["node"][-1].long(),
                       raw["final_state"]["node"])
    assert torch.equal(raw["traj"]["pos"][-1], raw["final_state"]["pos"])
    out_dir = str(tmp_path / "gen")
    res = pipe.generate(phore, num_samples=2, out_dir=out_dir, traj_stride=4)
    assert res["n_finished"] == 2
    with open(os.path.join(out_dir, "pipe_phore", "traj_1.sdf")) as f:
        text = f.read()
    assert text.count("$$$$") == len(range(0, T1, 4))
    assert "step_8" in text


def test_cli_follows_the_checkpoint_and_guards_narrowing(tmp_path):
    from phoregen_tpu_torch.cli import sample as cli
    args = cli.parse_args(["--ckpt", "x", "--phore", "y"])
    assert args.fused_stack == "" and args.triplet_knn == -1
    assert args.use_pallas_triplet == -1
    release = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "release", "flagship_r4")
    base = ["--ckpt", release, "--phore", "none.phore", "--device", "cpu",
            "--result_path", str(tmp_path)]
    with pytest.raises(SystemExit, match="narrows below"):
        cli.main(base + ["--triplet_knn", "8"])
    # 'pallas2' is ported: the CLI gets past the model and fails only on
    # the missing pharmacophore file
    with pytest.raises(FileNotFoundError, match="none.phore"):
        cli.main(base + ["--fused_stack", "pallas2"])
    # so are bf16 blocks (they used to be refused)
    with pytest.raises(FileNotFoundError, match="none.phore"):
        cli.main(base + ["--fused_block_dtype", "bfloat16"])
    # sharded pools are ported: two CPU shards get past the model too,
    # and more CUDA devices than are visible is refused, naming both
    with pytest.raises(FileNotFoundError, match="none.phore"):
        cli.main(base + ["--sample_devices", "2"])
    n_cuda = torch.cuda.device_count()
    with pytest.raises(SystemExit, match=f"{n_cuda} are visible"):
        cli.main(base + ["--device", "cuda", "--sample_devices",
                         str(n_cuda + 1)])
    # --chunk_steps and reference .pt checkpoints are ported too; a .pt
    # needs the --config that describes it
    with pytest.raises(FileNotFoundError, match="none.phore"):
        cli.main(base + ["--chunk_steps", "100"])
    with pytest.raises(SystemExit, match="requires --config"):
        cli.main(["--ckpt", "ref.pt", "--phore", "y"])
