"""The port's two model options beyond the release configurations against
the JAX package, on the same weights (through `from_jax_params`) and the
same injected draws: `categorical_space: continuous` (Gaussian diffusion
of the one-hot atom and bond types) and `bond_diffusion: false` (a pair
distance embedding in place of the bond types, no bond head), and the
transitions behind them (`GaussianTransition` on one-hots,
`UniformCategoricalTransition`). Small network: hidden 16, 2 heads, one
layer, kNN 4, T = 8.

Tolerances: the forward 1e-5 (atol = rtol; float32 on identical inputs,
measured 5e-7); the loss and its metrics 1e-5 relative; the parameter
gradients 1e-3 of each leaf's largest gradient, as
tests/test_torch_port_loss.py (measured 3.5e-4); one reverse step's
predictions 2e-4 and its positions 2e-4, as
tests/test_torch_port_sampler.py, its relaxed one-hots and posteriors
1e-5; transition tables and draws exactly, or 2e-6 in log space."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.config import default_config
from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.diffusion.categorical import \
    UniformCategoricalTransition as JUniform
from phoregen_tpu.diffusion.gaussian import GaussianTransition as JGauss
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.ops.masked import masked_mean as jmasked_mean
from phoregen_tpu.ops.schedules import get_beta_schedule
from phoregen_tpu.sample import sampler as jsampler

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.data.batching import PhoreGraphBatch, \
    replicate_phore
from phoregen_tpu_torch.data.phore import parse_phore_text
from phoregen_tpu_torch.diffusion.categorical import \
    UniformCategoricalTransition
from phoregen_tpu_torch.diffusion.gaussian import GaussianTransition
from phoregen_tpu_torch.models.phoregen import PhoreGen, init_params
from phoregen_tpu_torch.sample import sampler as psampler
from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
from phoregen_tpu_torch.utils.checkpoint import (flatten_tree,
                                                 from_jax_params,
                                                 to_jax_params)

from test_torch_port_sampler import PHORE_TEXT

T = 8
FWD = dict(atol=1e-5, rtol=1e-5)
PRED = dict(atol=2e-4, rtol=2e-4)
EXACT = dict(atol=1e-5, rtol=1e-5)
GUIDANCE = [dict(type="atom_prox", min_d=1.0, max_d=3.0),
            dict(type="center_prox")]
MODES = {   # name: (categorical_space, bond_diffusion)
    "continuous": ("continuous", True),
    "no_bond": ("discrete", False),
}


def mode_config(space, bond, fused="none"):
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 16
    m.denoiser.num_layers = 1
    m.denoiser.n_heads = 2
    m.denoiser.knn = 4
    m.denoiser.triplet_knn = 3
    m.denoiser.triplet_width = 8
    m.denoiser.fused_stack = fused
    m.diff.num_timesteps = T
    m.diff.time_dim = 2
    m.diff.categorical_space = space
    m.diff.scaling = [1.0, 2.0, 4.0]
    m.bond_diffusion = bond
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.dataset.corpus = "chains"
    return cfg.finalize()


def _t(a):
    return torch.from_numpy(np.array(a))


_SETUPS = {}


def _setup(space, bond, jfused="none", pfused="none"):
    """Both packages' models on the same initial parameters, made once a
    configuration."""
    key = (space, bond, jfused, pfused)
    if key not in _SETUPS:
        _SETUPS[key] = _build(*key)
    return _SETUPS[key]


def _build(space, bond, jfused, pfused):
    jcfg = mode_config(space, bond, jfused)
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    cfg = config_from_dict(jcfg.to_dict())
    cfg.model.denoiser.fused_stack = pfused
    pg = PhoreGen(cfg)
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    pg.net.eval()
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    return dict(jcfg=jcfg, batch=batch, tb=tb, jpg=jpg, params=params,
                pg=pg)


@pytest.fixture(scope="module", params=sorted(MODES))
def mode(request):
    return dict(_setup(*MODES[request.param]), name=request.param)


# ------------------------------------------------------------ the network

@pytest.mark.parametrize("jfused,pfused", [("none", "none"),
                                           ("xla", "pallas")])
def test_no_bond_forward_matches_jax(jfused, pfused):
    """`bond_diffusion: false` on the module path and through the fused
    stack (the JAX oracle `xla` against the port's plain stages on the
    CPU): predictions and count interval within 1e-5, pred_edge None in
    both, the same parameter names (`distance_embedding`, no
    `edge_embedder` or bond head)."""
    c = _setup("discrete", False, jfused, pfused)
    batch, tb = c["batch"], c["tb"]
    B, NL = batch.lig_type.shape
    rng = np.random.default_rng(5)
    x = dict(h_node=rng.normal(size=(B, NL, 12)).astype(np.float32),
             h_edge=rng.normal(size=(B, NL, NL, 6)).astype(np.float32),
             pos=(np.asarray(batch.lig_pos) + 0.1 * rng.normal(
                 size=batch.lig_pos.shape)).astype(np.float32),
             t=rng.integers(0, T, size=(B,)).astype(np.int32))
    ref = jax.jit(c["jpg"].net.apply)(
        c["params"], jnp.asarray(x["h_node"]), jnp.asarray(x["pos"]),
        batch.lig_mask, jnp.asarray(x["h_edge"]), jnp.asarray(x["t"]),
        batch.phore_x, batch.phore_pos, batch.phore_norm, batch.phore_mask)
    with torch.no_grad():
        out = c["pg"].net(_t(x["h_node"]), _t(x["pos"]), tb.lig_mask,
                          _t(x["h_edge"]), _t(x["t"]), tb.phore_x,
                          tb.phore_pos, tb.phore_norm, tb.phore_mask)
    assert out[2] is None and ref[2] is None
    lm = np.asarray(batch.lig_mask)
    for a, b in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy()[lm], np.asarray(b)[lm], **FWD)
    for a, b in zip(out[3], ref[3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)
    names = set(flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                    c["params"]["params"])))
    assert set(c["pg"].net.state_dict()) == names
    assert "distance_embedding.kernel" in names
    assert not any(n.startswith(("edge_embedder", "bond_inference"))
                   for n in names)


def test_no_bond_parameters_cross_and_initialise():
    """`to_jax_params` gives back the JAX tree leaf by leaf, and the
    port's own `init_params` fills `distance_embedding` as flax would
    (LeCun-normal kernel over fan-in 1, zero bias)."""
    c = _setup("discrete", False)
    tree = to_jax_params(c["pg"].net.state_dict())
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                              c["params"]["params"]))
    got = flatten_tree(tree)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    pg = PhoreGen(c["pg"].config)
    init_params(pg.net, seed=3)
    de = pg.net.distance_embedding
    assert tuple(de.kernel.shape) == (1, 14)
    # a unit-variance normal truncated at two of its standard deviations
    # (std 1 / 0.8796 before the cut)
    kernel = de.kernel.detach()
    assert float(kernel.abs().max()) <= 2.0 / 0.8796256610342398 + 1e-6
    assert float(kernel.std()) > 0.3
    assert torch.equal(de.bias, torch.zeros(14))


# ------------------------------------------------------------------ loss

def _jax_draws(key, batch, jpg, space):
    """The draws `PhoreGen.compute_loss` makes from `key`, in its order:
    class uniforms (discrete) or one-hot noise (continuous)."""
    kt, kjit, kpos, knode, kedge = jax.random.split(key, 5)
    B, NL = batch.lig_type.shape
    d = dict(t=jpg.sample_time(kt, B),
             jitter=jax.random.normal(kjit, (B, NL, 3)),
             pos_noise=jax.random.normal(kpos, (B, NL, 3)))
    if space == "discrete":
        d.update(node_uniform=jax.random.uniform(knode, (B, NL, 12)),
                 edge_uniform=jax.random.uniform(kedge, (B, NL, NL, 6)))
    else:
        d.update(node_noise=jax.random.normal(knode, (B, NL, 12)),
                 edge_noise=jax.random.normal(kedge, (B, NL, NL, 6)))
    return {k: _t(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def loss_case(mode):
    jpg, params, batch = mode["jpg"], mode["params"], mode["batch"]
    key = jax.random.PRNGKey(21)

    def f(p):
        return jpg.compute_loss(p, key, batch, lig_noise_std=0.1)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    pg = mode["pg"]
    pg.net.zero_grad(set_to_none=True)
    ploss, pmetrics = pg.compute_loss(
        mode["tb"], None, lig_noise_std=0.1,
        **_jax_draws(key, batch, jpg, MODES[mode["name"]][0]))
    ploss.backward()
    out = dict(loss=float(loss), metrics=metrics, grads=grads,
               ploss=float(ploss.detach()), pmetrics=pmetrics,
               pgrads={n: p.grad.clone()
                       for n, p in pg.net.named_parameters()})
    pg.net.zero_grad(set_to_none=True)
    return out


def test_loss_and_metrics_match_jax(mode, loss_case):
    """The continuous space's loss (MSE against the scaled one-hots x 30)
    and the no-bond loss (no edge term): loss and every metric within
    1e-5 relative, and the same metric names (no edge metrics without
    bond diffusion)."""
    c = loss_case
    assert c["ploss"] == pytest.approx(c["loss"], rel=1e-5)
    assert set(c["pmetrics"]) == set(c["metrics"])
    assert ("loss_edge" in c["metrics"]) == (mode["name"] != "no_bond")
    for k, v in c["metrics"].items():
        assert float(c["pmetrics"][k].detach()) == pytest.approx(
            float(v), rel=1e-5, abs=1e-6), k


def test_loss_gradients_match_jax(loss_case):
    c = loss_case
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                              c["grads"]["params"]))
    assert set(c["pgrads"]) == set(ref)
    bad = {}
    for k, r in ref.items():
        g = c["pgrads"][k]
        assert torch.isfinite(g).all(), k
        err = float(np.abs(g.numpy() - r).max()
                    / max(float(np.abs(r).max()), 1e-3))
        if err >= 1e-3:
            bad[k] = err
    assert not bad, bad


# ---------------------------------------------------------- reverse step

def _sampling_batch(pg, counts=(5, 9, 12)):
    sample = GenerationPipeline(pg, device="cpu").prepare_phore(
        parse_phore_text(PHORE_TEXT, "pipe_phore"))
    return replicate_phore(sample, len(counts), np.asarray(counts), 16)


def test_schedule_tables_match_jax():
    """The continuous space's strided schedule: the Gaussian (coef_x0,
    coef_xt, std) of the node and edge betas, exactly the JAX tables."""
    c = _setup("continuous", True)
    sp = psampler.Sampler(c["pg"], sample_steps=5)
    ts, node, edge, gauss = sp.schedule()
    jts, jnode, jedge, jgauss = jsampler.Sampler(
        c["jpg"], sample_steps=5)._build_schedule(5, T)
    np.testing.assert_array_equal(ts, np.asarray(jts))
    for got, want in zip((node, edge, gauss), (jnode, jedge, jgauss)):
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_one_reverse_step_matches_jax(mode):
    """One strided step (i = 2 of 8) with injected draws, guidance
    atom_prox + center_prox. Continuous: the relaxed one-hots' posterior
    mean (`get_prev_with`) on the port's predictions within 1e-5.
    No-bond: the node posterior within 1e-5, the bond state untouched,
    atom_prox skipped (the guidance gradient is center_prox's alone), no
    pred_edge. Positions: the Gaussian mean within 2e-4."""
    jpg, params, pg = mode["jpg"], mode["params"], mode["pg"]
    space, bond = MODES[mode["name"]]
    hb = _sampling_batch(pg)
    batch = hb.to("cpu")
    sp = psampler.Sampler(pg, [psampler.GuidanceOpt(**g) for g in GUIDANCE])
    inv = sp.prepare(batch)
    state = sp.init_state(batch, torch.Generator().manual_seed(0))
    B, NL = batch.lig_mask.shape
    rng = np.random.default_rng(7)
    draws = {"pos_noise": _t(rng.normal(size=(B, NL, 3)).astype(np.float32))}
    if space == "discrete":
        draws["node_u"] = _t(rng.uniform(size=(B, NL, 12)).astype(np.float32))
        draws["edge_u"] = _t(rng.uniform(size=(B, NL, NL, 6)
                                         ).astype(np.float32))
        assert state["node"].dtype == torch.int64
    else:
        draws["node_noise"] = _t(rng.normal(size=(B, NL, 12)
                                            ).astype(np.float32))
        draws["edge_noise"] = _t(rng.normal(size=(B, NL, NL, 6)
                                            ).astype(np.float32))
        assert tuple(state["node"].shape) == (B, NL, 12)
        assert state["log_node"] is None
    i = 2
    new, (pn, pp, pe) = sp.step(state, i, batch, inv, False, draws=draws)

    J = lambda a: jnp.asarray(a.numpy())
    oh = jax.nn.one_hot
    ts, node_tabs, edge_tabs, gauss = jsampler.Sampler(jpg)._build_schedule(
        T, T)
    h_node = oh(J(state["node"]), 12) if space == "discrete" \
        else J(state["node"])
    h_edge = oh(J(state["edge"]), 6) if space == "discrete" \
        else J(state["edge"])
    ref = jax.jit(jpg.net.apply)(
                        params, h_node, J(state["pos"]), J(batch.lig_mask),
                        h_edge, jnp.full((B,), int(ts[i]), jnp.int32),
                        J(batch.phore_x), J(batch.phore_pos),
                        J(batch.phore_norm), J(batch.phore_mask))
    lm = hb.lig_mask
    bm = lm[:, :, None] & lm[:, None, :]
    np.testing.assert_allclose(pn.numpy()[lm], np.asarray(ref[0])[lm], **PRED)
    np.testing.assert_allclose(pp.numpy()[lm], np.asarray(ref[1])[lm], **PRED)
    assert (pe is None) == (ref[2] is None) == (not bond)
    if bond:
        np.testing.assert_allclose(pe.numpy()[bm], np.asarray(ref[2])[bm],
                                   **PRED)

    if space == "continuous":
        for name, pred, tabs, key in (("node", pn, node_tabs, "node_noise"),
                                      ("edge", pe, edge_tabs, "edge_noise")):
            mu = jpg.node_transition.get_prev_with(
                jax.random.PRNGKey(0), J(state[name]), J(pred), tabs[0][i],
                tabs[1][i], tabs[2][i], True)
            port_mu = new[name] - float(tabs[2][i]) * draws[key]
            np.testing.assert_allclose(port_mu.numpy(), np.asarray(mu),
                                       **EXACT)
        h_edge_new = J(new["edge"])
    else:
        log_node = jpg.node_transition.q_v_posterior_mats(
            jax.nn.log_softmax(J(pn), -1), J(state["log_node"]),
            node_tabs[0][i], node_tabs[1][i], False)
        np.testing.assert_allclose(new["log_node"].numpy(),
                                   np.asarray(log_node), **EXACT)
        assert torch.equal(new["edge"], state["edge"])
        assert torch.equal(new["log_edge"], state["log_edge"])
        h_edge_new = oh(J(new["edge"]), 6)

    lig_mask = J(batch.lig_mask)
    bond_mask = lig_mask[:, :, None] & lig_mask[:, None, :] \
        & ~jnp.eye(NL, dtype=bool)
    p_mask = (J(batch.phore_x)[..., jpg.ex_col] != 1) & J(batch.phore_mask)
    center = jmasked_mean(J(batch.phore_pos), p_mask[..., None], axis=1)

    def energy(p):
        e = jsampler.center_prox_energy(p, lig_mask, center)
        if bond:
            e = e + jsampler.atom_prox_energy(p, h_edge_new, bond_mask,
                                              lig_mask, 1.0, 3.0)
        return e
    grad = jax.grad(energy)(J(state["pos"]))
    mu = jpg.pos_transition.get_prev_with(
        jax.random.PRNGKey(0), J(state["pos"]), J(pp), gauss[0][i],
        gauss[1][i], gauss[2][i], True, energy_grad=grad)
    port_mu = new["pos"] - float(gauss[2][i]) * draws["pos_noise"]
    np.testing.assert_allclose(port_mu.numpy(), np.asarray(mu), **PRED)


def test_whole_chain_and_trajectories(mode):
    """A full T-step chain in each mode: finite outputs of the right
    shapes, pred_edge None without bond diffusion, the trajectory holding
    what the JAX `ys` holds (class ids, or relaxed one-hots), and the
    pipeline decoding the pool (no bonds without bond diffusion)."""
    pg = mode["pg"]
    space, bond = MODES[mode["name"]]
    batch = _sampling_batch(pg).to("cpu")
    sp = psampler.Sampler(pg, [psampler.GuidanceOpt(**g) for g in GUIDANCE],
                          keep_traj=True)
    out = sp.sample(batch, torch.Generator().manual_seed(4))
    B, NL = batch.lig_mask.shape
    assert tuple(out["pred_node"].shape) == (B, NL, 12)
    assert torch.isfinite(out["pred_pos"]).all()
    assert (out["pred_edge"] is None) == (not bond)
    node = out["traj"]["node"]
    if space == "continuous":
        assert node.dtype == torch.float32
        assert tuple(node.shape) == (T + 1, B, NL, 12)
        assert tuple(out["traj"]["edge"].shape) == (T + 1, B, NL, NL, 6)
    else:
        assert node.dtype == torch.int8 and tuple(node.shape) == (T + 1, B,
                                                                  NL)
        # the bond state keeps its prior draw
        assert (out["traj"]["edge"] == out["traj"]["edge"][0]).all()
    assert torch.equal(node[-1], out["final_state"]["node"].to(node.dtype))
    pipe = GenerationPipeline(pg, device="cpu")
    from phoregen_tpu_torch.sample.decode import decode_batch
    arrays = [None if out[k] is None else out[k].numpy()
              for k in ("pred_node", "pred_pos", "pred_edge", "lig_mask")]
    mols = decode_batch(*arrays, include_bond=pipe.cfg.model.bond_diffusion)
    assert len(mols) == B
    assert all((m["bond_index"] is None) == (not bond) for m in mols)


# ----------------------------------------------------------- transitions

def _betas():
    return np.asarray(get_beta_schedule("cosine", T, s=0.01))


def test_gaussian_transition_on_class_ids_matches_jax():
    """`create(num_classes=...)`: the one-hot form of `add_noise` (scaled
    one-hots, noised) and `get_prev_from_recon` with per-graph t (t == 0
    gives the mean), on the draws JAX makes from its keys."""
    jg = JGauss.create(_betas(), 6, 2.0)
    pgt = GaussianTransition.create(_betas(), 6, 2.0)
    rng = np.random.default_rng(0)
    v = rng.integers(0, 6, size=(4, 5))
    t = np.asarray([0, 3, 7, 1], np.int32)
    key = jax.random.PRNGKey(3)
    pert, x0 = jg.add_noise(key, jnp.asarray(v), jnp.asarray(t))
    noise = jax.random.normal(key, (4, 5, 6))
    ppert, px0 = pgt.add_noise(_t(v), _t(t), noise=_t(noise))
    np.testing.assert_array_equal(px0.numpy(), np.asarray(x0))
    np.testing.assert_allclose(ppert.numpy(), np.asarray(pert), atol=1e-6,
                               rtol=1e-6)
    x_t = rng.normal(size=(4, 5, 6)).astype(np.float32)
    recon = rng.normal(size=(4, 5, 6)).astype(np.float32)
    eg = 0.1 * rng.normal(size=(4, 5, 6)).astype(np.float32)
    k2 = jax.random.PRNGKey(4)
    want = jg.get_prev_from_recon(k2, jnp.asarray(x_t), jnp.asarray(recon),
                                  jnp.asarray(t), energy_grad=jnp.asarray(eg))
    got = pgt.get_prev_from_recon(
        _t(x_t), _t(recon), _t(t), energy_grad=_t(eg),
        noise=_t(jax.random.normal(k2, (4, 5, 6))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    for name in ("coef_x0", "coef_xt", "std"):
        np.testing.assert_array_equal(getattr(pgt, name),
                                      np.asarray(getattr(jg, name)))


def test_uniform_categorical_transition_matches_jax():
    """The reference's legacy uniform-prior class: forward marginals,
    posteriors (soft and hardened v0), the loss split, and sampling on the
    uniforms JAX draws from its keys."""
    K = 5
    jc = JUniform.create(_betas(), K)
    pc = UniformCategoricalTransition(_betas(), K)
    for name in ("log_alphas", "log_1m_alphas", "log_alphas_bar",
                 "log_1m_alphas_bar"):
        np.testing.assert_array_equal(getattr(pc, name),
                                      np.asarray(getattr(jc, name)))
    rng = np.random.default_rng(1)
    lp = lambda: np.asarray(jax.nn.log_softmax(jnp.asarray(
        rng.normal(size=(4, 6, K)).astype(np.float32)), -1))
    log_v0, log_vt = lp(), lp()
    t = np.asarray([0, 1, 7, 3], np.int32)
    post = dict(atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(
        pc.q_vt_pred(_t(log_v0), _t(t)).numpy(),
        np.asarray(jc.q_vt_pred(jnp.asarray(log_v0), jnp.asarray(t))),
        **post)
    posts = {}
    for v0_prob in (True, False):
        want = jc.q_v_posterior(jnp.asarray(log_v0), jnp.asarray(log_vt),
                                jnp.asarray(t), v0_prob=v0_prob)
        got = pc.q_v_posterior(_t(log_v0), _t(log_vt), _t(t),
                               v0_prob=v0_prob)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **post)
        posts[v0_prob] = (got, want)
    np.testing.assert_allclose(
        pc.compute_v_Lt(posts[True][0], posts[False][0], _t(log_v0),
                        _t(t)).numpy(),
        np.asarray(jc.compute_v_Lt(posts[True][1], posts[False][1],
                                   jnp.asarray(log_v0), jnp.asarray(t))),
        atol=1e-5, rtol=1e-5)
    v = rng.integers(0, K, size=(4, 6))
    key = jax.random.PRNGKey(5)
    jv, jlog_vt, jlog_v0 = jc.add_noise(key, jnp.asarray(v), jnp.asarray(t))
    u = jax.random.uniform(key, (4, 6, K))
    pv, plog_vt, plog_v0 = pc.add_noise(_t(v), _t(t), uniform=_t(u))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(plog_vt.numpy(), np.asarray(jlog_vt))
    np.testing.assert_array_equal(plog_v0.numpy(), np.asarray(jlog_v0))
    jids, joh, jlog = jc.sample_init(key, (4, 6))
    pids, poh, plog = pc.sample_init((4, 6), None, "cpu", uniform=_t(u))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(poh.numpy(), np.asarray(joh))
    np.testing.assert_array_equal(plog.numpy(), np.asarray(jlog))


@pytest.mark.parametrize("name", sorted(MODES))
def test_cli_train_runs_each_mode_on_the_cpu(name, tmp_path):
    """`cli.train` trains both options for an epoch: finite loss, the
    loss terms of the mode in the history, a checkpoint written."""
    import json
    import os

    import yaml
    from phoregen_tpu_torch.cli import train as cli
    cfg = config_from_dict(mode_config(*MODES[name]).to_dict())
    cfg.train.batch_size = 4
    cfg.train.dtype = "float32"
    cfg.logger.result = str(tmp_path)
    cfg.logger.run_name = name
    cfg.logger.tensorboard = False
    path = os.path.join(str(tmp_path), "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    hist = cli.main(["--config", path, "--epochs", "1", "--synthetic_size",
                     "8", "--device", "cpu"])
    row = hist["train"][0]
    assert np.isfinite(row["loss"]) and np.isfinite(row["loss_node"])
    assert ("loss_edge" in row) == MODES[name][1]
    run_dir = os.path.join(str(tmp_path), name)
    assert os.path.exists(os.path.join(run_dir, "best_model.msgpack"))
    with open(os.path.join(run_dir, "best_model.json")) as f:
        meta = json.load(f)
    assert meta["config"]["model"]["diff"]["categorical_space"] == \
        MODES[name][0]
