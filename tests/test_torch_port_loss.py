"""The training half of the port's diffusion model against the JAX package:
the transitions' forward noising, posteriors and loss split, the interval
loss and accuracies, and `PhoreGen.compute_loss` with its parameter
gradients. JAX's threefry and torch's Philox cannot give the same numbers
from a seed, so every draw is made once with `jax.random` from the keys
the JAX function uses and injected into the port.

Tolerances: posteriors 2e-6 (log-space float32 on [K, K] tables built in
float64 on both sides); loss and metrics 1e-4 relative; parameter gradients
1e-3 of each leaf's largest gradient (a three-term loss through two
attention layers in float32; the fused stack's JAX side takes the triplet
angle from a polynomial)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.diffusion import CategoricalTransition as JCat
from phoregen_tpu.diffusion import GaussianTransition as JGauss
from phoregen_tpu.models import phoregen as jpgm
from phoregen_tpu.ops.schedules import get_beta_schedule

from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.diffusion.categorical import CategoricalTransition
from phoregen_tpu_torch.diffusion.gaussian import GaussianTransition
from phoregen_tpu_torch.models import phoregen as ppgm
from phoregen_tpu_torch.utils.checkpoint import flatten_tree, from_jax_params

from test_torch_port_model import port_config, small_config

T = 8
POST = dict(atol=2e-6, rtol=2e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- transitions

@pytest.fixture(scope="module", params=[("tomask", 12), ("absorb", 6),
                                        ("uniform", 5)])
def cats(request):
    init, K = request.param
    betas = np.asarray(get_beta_schedule("cosine", T, s=0.01))
    return (JCat.create(betas, K, init), CategoricalTransition(betas, K, init),
            K)


def _log_probs(rng, shape, K):
    logits = rng.normal(size=shape + (K,)).astype(np.float32)
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))


def test_num_timesteps_matches_jax(cats):
    jc, pc, _ = cats
    assert pc.num_timesteps == jc.num_timesteps == T


def test_q_vt_pred_and_posterior_match_jax(cats):
    jc, pc, K = cats
    rng = np.random.default_rng(0)
    t = np.asarray([0, 1, T - 1, 3], np.int32)
    log_v0 = _log_probs(rng, (4, 5, 5), K)
    log_vt = _log_probs(rng, (4, 5, 5), K)
    np.testing.assert_allclose(
        pc.q_vt_pred(_t(log_v0), _t(t)).numpy(),
        np.asarray(jc.q_vt_pred(jnp.asarray(log_v0), jnp.asarray(t))), **POST)
    for v0_prob in (True, False):
        ref = jc.q_v_posterior(jnp.asarray(log_v0), jnp.asarray(log_vt),
                               jnp.asarray(t), v0_prob=v0_prob)
        out = pc.q_v_posterior(_t(log_v0), _t(log_vt), _t(t),
                               v0_prob=v0_prob)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **POST)
    # t == 0 returns log_v0 itself
    assert torch.equal(pc.q_v_posterior(_t(log_v0), _t(log_vt), _t(t))[0],
                       _t(log_v0)[0])


def test_compute_v_Lt_matches_jax(cats):
    jc, pc, K = cats
    rng = np.random.default_rng(1)
    t = np.asarray([0, 2, T - 1], np.int32)
    a, b, v0 = (_log_probs(rng, (3, 7), K) for _ in range(3))
    ref = jc.compute_v_Lt(jnp.asarray(a), jnp.asarray(b), jnp.asarray(v0),
                          jnp.asarray(t))
    out = pc.compute_v_Lt(_t(a), _t(b), _t(v0), _t(t))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_categorical_add_noise_matches_jax_on_injected_uniform(cats):
    jc, pc, K = cats
    rng = np.random.default_rng(2)
    v = rng.integers(0, K, size=(4, 6)).astype(np.int32)
    t = np.asarray([0, 3, 5, T - 1], np.int32)
    key = jax.random.PRNGKey(3)
    ref = jc.add_noise(key, jnp.asarray(v), jnp.asarray(t))
    uniform = np.asarray(jax.random.uniform(key, v.shape + (K,)))
    out = pc.add_noise(_t(v), _t(t), uniform=_t(uniform))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **POST)
    np.testing.assert_array_equal(pc.onehot_encode(_t(v)).numpy(),
                                  np.asarray(jc.onehot_encode(jnp.asarray(v))))
    # from a generator: one-hot rows, reproducible
    g = lambda: torch.Generator().manual_seed(5)
    o1 = pc.add_noise(_t(v), _t(t), g())[0]
    assert torch.equal(o1, pc.add_noise(_t(v), _t(t), g())[0])
    assert torch.equal(o1.sum(-1), torch.ones(4, 6))


def test_gaussian_add_noise_matches_jax_on_injected_noise():
    betas = np.asarray(get_beta_schedule("cosine", T, s=0.01))
    jg, pgt = JGauss.create(betas), GaussianTransition(betas)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 3)).astype(np.float32)
    t = np.asarray([0, 4, T - 1], np.int32)
    key = jax.random.PRNGKey(9)
    ref = jg.add_noise(key, jnp.asarray(x), jnp.asarray(t))
    noise = np.asarray(jax.random.normal(key, x.shape))
    out = pgt.add_noise(_t(x), _t(t), noise=_t(noise))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)
    # the one-hot-relaxed form returns (x_t, scaled x_0)
    jg2, pg2 = JGauss.create(betas, 5, 2.0), GaussianTransition(betas, 5, 2.0)
    v = rng.integers(0, 5, size=(3, 4)).astype(np.int32)
    ref = jg2.add_noise(key, jnp.asarray(v), jnp.asarray(t))
    noise = np.asarray(jax.random.normal(key, v.shape + (5,)))
    out = pg2.add_noise(_t(v), _t(t), noise=_t(noise))
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-6)


# ------------------------------------------------------ interval loss, metrics

@pytest.mark.parametrize("weighted", [False, True])
def test_qd_loss_matches_jax(weighted):
    rng = np.random.default_rng(6)
    y = rng.uniform(size=(9, 1)).astype(np.float32)
    lo = (y - rng.uniform(-0.1, 0.3, size=y.shape)).astype(np.float32)
    up = (lo + rng.uniform(0.0, 0.5, size=y.shape)).astype(np.float32)
    lo[0], up[1] = y[0], y[1]          # sign(0) = 0: the hard count is 0
    w = (rng.uniform(size=y.shape) > 0.3).astype(np.float32) \
        if weighted else None
    ref = jpgm.qd_loss(jnp.asarray(y), jnp.asarray(lo), jnp.asarray(up),
                       factor=1.5, weights=None if w is None
                       else jnp.asarray(w))
    out = ppgm.qd_loss(_t(y), _t(lo), _t(up), factor=1.5,
                       weights=None if w is None else _t(w))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_accuracies_match_jax(weighted):
    rng = np.random.default_rng(7)
    true = rng.integers(0, 6, size=(5, 4, 4)).astype(np.int32)
    logits = rng.normal(size=(5, 4, 4, 6)).astype(np.float32)
    logits[0] = np.eye(6, dtype=np.float32)[true[0]] * 9.0   # a perfect graph
    mask = rng.uniform(size=true.shape) > 0.4
    mask[3] = False                          # an empty graph: floor of 1
    gw = np.asarray([1, 1, 0, 1, 0], bool) if weighted else None
    for jf, pf in ((jpgm.exact_match_accuracy, ppgm.exact_match_accuracy),
                   (jpgm.element_accuracy, ppgm.element_accuracy)):
        ref = jf(jnp.asarray(true), jnp.asarray(logits), jnp.asarray(mask),
                 None if gw is None else jnp.asarray(gw))
        out = pf(_t(true), _t(logits), _t(mask),
                 None if gw is None else _t(gw))
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_sample_time_is_antithetic():
    pg = ppgm.PhoreGen(port_config(small_config("xla"), "none"))
    t = pg.sample_time(7, torch.Generator().manual_seed(0), "cpu")
    assert t.shape == (7,) and int(t.min()) >= 0 and int(t.max()) < T
    assert torch.equal(t[4:], T - 1 - t[:3])


# ------------------------------------------------------------ compute_loss

def _jax_draws(key, batch, lig_noise_std, pg):
    """The draws `PhoreGen.compute_loss` makes from `key`, in its order."""
    kt, kjit, kpos, knode, kedge = jax.random.split(key, 5)
    B, NL = batch.lig_type.shape
    d = dict(t=np.asarray(pg.sample_time(kt, B)),
             pos_noise=np.asarray(jax.random.normal(kpos, (B, NL, 3))),
             node_uniform=np.asarray(jax.random.uniform(knode, (B, NL, 12))),
             edge_uniform=np.asarray(jax.random.uniform(kedge,
                                                        (B, NL, NL, 6))))
    if lig_noise_std > 0:
        d["jitter"] = np.asarray(jax.random.normal(kjit, (B, NL, 3)))
    return {k: _t(v) for k, v in d.items()}


CASES = {   # name: (JAX fused_stack, port fused_stack, graph mask, jitter)
    "module": ("none", "none", False, 0.1),
    "pallas2": ("xla", "pallas2", False, 0.1),
    "pallas2_graph_mask": ("xla", "pallas2", True, 0.0),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def loss_case(request):
    jfused, pfused, masked, std = CASES[request.param]
    jcfg = small_config(jfused)
    jcfg.model.denoiser.num_layers = 2
    jcfg.model.bond_len_loss = True
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = jpgm.PhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(21)
    gm = np.asarray([True, False, True]) if masked else None

    def f(p):
        return jpg.compute_loss(p, key, batch, lig_noise_std=std,
                                graph_mask=None if gm is None
                                else jnp.asarray(gm))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    pg = ppgm.PhoreGen(port_config(jcfg, pfused))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    ploss, pmetrics = pg.compute_loss(
        tb, None, lig_noise_std=std,
        graph_mask=None if gm is None else _t(gm),
        **_jax_draws(key, batch, std, jpg))
    ploss.backward()
    return dict(loss=float(loss), metrics=metrics, grads=grads, pg=pg,
                ploss=float(ploss.detach()), pmetrics=pmetrics)


def test_compute_loss_and_metrics_match_jax(loss_case):
    c = loss_case
    assert c["ploss"] == pytest.approx(c["loss"], rel=1e-4)
    assert set(c["pmetrics"]) == set(c["metrics"])
    for k, v in c["metrics"].items():
        assert float(c["pmetrics"][k].detach()) == pytest.approx(
            float(v), rel=1e-4, abs=1e-6), k


def test_loss_parameter_gradients_match_jax(loss_case):
    c = loss_case
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                              c["grads"]["params"]))
    named = dict(c["pg"].net.named_parameters())
    assert set(named) == set(ref)
    bad = {}
    for k, r in ref.items():
        g = named[k].grad
        assert g is not None and torch.isfinite(g).all(), k
        err = float(np.abs(g.numpy() - r).max()
                    / max(float(np.abs(r).max()), 1e-3))
        if err >= 1e-3:
            bad[k] = err
    assert not bad, bad


def test_bf16_compute_dtype_raises_and_names_the_roadmap():
    """`compute_dtype` bfloat16 used to raise; now it runs the network in
    bf16 and its loss stays within 5% of the float32 loss on the same
    draws (tests/test_train.py holds the JAX package to the same bound;
    the JAX comparison is tests/test_torch_port_bf16_model.py). An unknown
    dtype raises."""
    jcfg = small_config("none")
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 3, max_atoms=12),
                                      jcfg, 3, shuffle=False)))
    jpg = jpgm.PhoreGen(jcfg)
    pg = ppgm.PhoreGen(port_config(jcfg, "none"))
    pg.net.load_state_dict(from_jax_params(jpg.init_params(
        jax.random.PRNGKey(0), batch)), strict=True)
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    draws = _jax_draws(jax.random.PRNGKey(21), batch, 0.1, jpg)
    with torch.no_grad():
        loss = {dt: pg.compute_loss(tb, None, lig_noise_std=0.1,
                                    compute_dtype=dt, **draws)[0]
                for dt in ("float32", "bfloat16")}
    assert loss["bfloat16"].dtype == torch.float32
    assert torch.isfinite(loss["bfloat16"])
    assert float(loss["bfloat16"]) == pytest.approx(float(loss["float32"]),
                                                    rel=0.05)
    assert float(loss["bfloat16"]) != float(loss["float32"])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pg.compute_loss(tb, None, compute_dtype="float16", **draws)
