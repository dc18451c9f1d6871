"""The port's trainer against the JAX package's: grad-norm queue, clipping,
EMA, plateau schedule and step seeds; Adam / AdamW against optax from the
same state and gradients; `freeze_pos`; whole train steps on injected
draws; `Run.train` and the train CLI on the CPU.

Tolerances: optimizer updates 1e-6 (the same float32 arithmetic in another
order); parameters after three train steps 1e-5 absolute at lr 1e-4 (Adam's
first steps move every leaf by about lr, whatever the gradient's size, so
gradient differences of 1e-3 relative move a parameter by ~1e-7; leaves
whose gradient is near Adam's eps move by up to lr x their relative
difference)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from phoregen_tpu.config import default_config as jdefault_config
from phoregen_tpu.data.loader import PhoreDataLoader as JLoader
from phoregen_tpu.data.synthetic import synthetic_dataset as jsynthetic
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.train import loop as jloop
from phoregen_tpu.train import state as jstate
from phoregen_tpu.train.step import make_train_step as jmake_train_step

from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.data.dataset import get_dataset
from phoregen_tpu_torch.data.loader import PhoreDataLoader
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.train import loop as ploop
from phoregen_tpu_torch.train import state as pstate
from phoregen_tpu_torch.train.checkpoint import from_jax_train_state
from phoregen_tpu_torch.train.step import make_eval_step, make_train_step
from phoregen_tpu_torch.utils.checkpoint import flatten_tree

from test_torch_port_loss import _jax_draws
from test_torch_port_model import port_config, small_config


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------- queue, clip, EMA, schedule

def test_grad_norm_queue_matches_jax():
    jq, pq = jstate.GradNormQueue.create(), pstate.GradNormQueue("cpu")
    rng = np.random.default_rng(0)
    for v in rng.uniform(1.0, 500.0, size=60).astype(np.float32):
        for a, b in zip(pq.stats(), jq.stats()):
            assert float(a) == pytest.approx(float(b), rel=1e-6)
        jq = jq.push(jnp.asarray(v))
        pq.push(torch.tensor(v))
        assert (pq.count, pq.head) == (int(jq.count), int(jq.head))
    np.testing.assert_array_equal(pq.values.numpy(), np.asarray(jq.values))
    assert pq.count == pstate.QUEUE_LEN == 50
    assert float(pstate.GradNormQueue("cpu").stats()[0]) == 3000.0


@pytest.mark.parametrize("scale", [1.0, 1e4])    # below / above threshold
def test_clip_by_queue_and_fixed_match_jax(scale):
    rng = np.random.default_rng(1)
    grads = [(scale * rng.normal(size=s)).astype(np.float32)
             for s in ((4, 3), (7,), (2, 2, 2))]
    jq = jstate.GradNormQueue.create().push(jnp.asarray(2500.0))
    pq = pstate.GradNormQueue("cpu")
    pq.push(torch.tensor(2500.0))
    jc, jq2, jn = jstate.clip_by_queue([jnp.asarray(g) for g in grads], jq)
    pg = [_t(g) for g in grads]
    pn = pstate.clip_by_queue(pg, pq)
    assert float(pn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(pg, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(pq.values.numpy(), np.asarray(jq2.values),
                               rtol=1e-6)
    # the value pushed is min(gnorm, threshold)
    mean, std = jq.stats()
    assert float(pq.values[2]) == pytest.approx(
        min(float(jn), 1.5 * float(mean) + 2 * float(std)), rel=1e-6)
    jc, jn = jstate.clip_fixed([jnp.asarray(g) for g in grads], 10.0)
    pg = [_t(g) for g in grads]
    assert float(pstate.clip_fixed(pg, 10.0)) == pytest.approx(float(jn),
                                                               rel=1e-6)
    for a, b in zip(pg, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_ema_update_matches_jax():
    net = torch.nn.Linear(3, 2)
    ema = {n: torch.randn_like(p) for n, p in net.named_parameters()}
    ref = jstate.ema_update(
        {n: jnp.asarray(v.numpy()) for n, v in ema.items()},
        {n: jnp.asarray(p.detach().numpy())
         for n, p in net.named_parameters()}, 0.99)
    pstate.ema_update(ema, net, 0.99)
    for n in ema:
        np.testing.assert_allclose(ema[n].numpy(), np.asarray(ref[n]),
                                   rtol=1e-6, atol=1e-7)


def test_plateau_scheduler_matches_jax():
    args = dict(factor=0.5, patience=1, min_lr=1e-3, lr=1.0)
    js, ps = jloop.PlateauScheduler(**args), ploop.PlateauScheduler(**args)
    rng = np.random.default_rng(2)
    for m in np.concatenate([[1.0, 2.0, 2.0, 0.5], rng.uniform(size=40) + 1]):
        assert ps.step(float(m)) == js.step(float(m))
    assert ps.state_dict() == js.state_dict() and ps.lr == 1e-3
    ps2 = ploop.PlateauScheduler(**args)
    ps2.load_state_dict(js.state_dict())
    assert ps2.state_dict() == js.state_dict()


def test_mix_step_seed_exact_for_1000_tuples():
    rng = np.random.default_rng(3)
    seen = set()
    for _ in range(1000):
        seed, epoch, idx = (int(rng.integers(0, 2 ** 31)),
                            int(rng.integers(0, 400)),
                            int(rng.integers(0, 10 ** 6)))
        mode = "train" if rng.uniform() < 0.5 else "valid"
        out = ploop.mix_step_seed(seed, epoch, mode, idx)
        assert out == jloop.mix_step_seed(seed, epoch, mode, idx)
        assert out.dtype == np.uint32
        seen.add(int(out))
    assert len(seen) > 990


# -------------------------------------------------------------- optimizers

class _Tree(torch.nn.Module):
    """Parameters named like the denoiser's: two trained leaves and one
    under a position-update layer."""

    def __init__(self, vals):
        super().__init__()
        self.node = torch.nn.ParameterDict(
            {"kernel": torch.nn.Parameter(_t(vals["node"]["kernel"]))})
        self.pos_layer_with_edge = torch.nn.ParameterDict(
            {"kernel": torch.nn.Parameter(
                _t(vals["pos_layer_with_edge"]["kernel"]))})
        self.head = torch.nn.ParameterDict(
            {"bias": torch.nn.Parameter(_t(vals["head"]["bias"]))})


def _tree_vals(rng, scale=1.0):
    return {"node": {"kernel": (scale * rng.normal(size=(4, 3))
                                ).astype(np.float32)},
            "pos_layer_with_edge": {"kernel": (scale * rng.normal(size=(3, 2))
                                               ).astype(np.float32)},
            "head": {"bias": (scale * rng.normal(size=(5,))
                              ).astype(np.float32)}}


def _tcfg(opt, freeze=False):
    tcfg = jdefault_config().train
    tcfg.optimizer.type = opt
    tcfg.optimizer.lr = 1e-2
    tcfg.optimizer.weight_decay = 0.05
    tcfg.freeze_pos = freeze
    return tcfg


@pytest.mark.parametrize("opt", ["adam", "adamw"])
def test_five_optimizer_steps_match_optax(opt):
    rng = np.random.default_rng(4)
    vals = _tree_vals(rng)
    tcfg = _tcfg(opt)
    tx = jstate.make_optimizer(tcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, vals)
    opt_state = tx.init(jparams)
    net = _Tree(vals)
    popt = pstate.make_optimizer(tcfg, net)
    assert not popt.defaults.get("amsgrad", False)
    for step in range(5):
        g = _tree_vals(rng, scale=10.0 ** (step - 3))
        upd, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in net.named_parameters():
            a, b = n.split(".")
            p.grad = _t(g[a][b])
        popt.step()
        for n, p in net.named_parameters():
            a, b = n.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[a][b]), atol=1e-6,
                                       rtol=1e-6)
    pstate.set_learning_rate(popt, 3e-5)
    assert pstate.get_learning_rate(popt) == pytest.approx(3e-5)


def test_optimizer_and_train_state_take_the_jax_keyword_cfg():
    """`make_optimizer` and `create_train_state` take the TrainConfig as
    `cfg`, as the JAX package's do: the same learning rate, a fresh step
    count and an EMA shadow equal to the params."""
    vals = _tree_vals(np.random.default_rng(6))
    tcfg = _tcfg("adamw")
    jst = jstate.create_train_state(
        cfg=tcfg, params=jax.tree_util.tree_map(jnp.asarray, vals))
    net = _Tree(vals)
    pst = pstate.create_train_state(cfg=tcfg, net=net)
    lr = np.float32(jstate.get_learning_rate(jst.opt_state))   # optax: f32
    assert np.float32(pstate.get_learning_rate(pst.optimizer)) == lr
    assert np.float32(pstate.get_learning_rate(
        pstate.make_optimizer(cfg=tcfg, net=net))) == lr
    assert pst.step == int(jst.step) == 0
    for n, p in net.named_parameters():
        a, b = n.split(".")
        assert torch.equal(pst.ema_params[n], p.detach())
        np.testing.assert_array_equal(pst.ema_params[n].numpy(),
                                      np.asarray(jst.ema_params[a][b]))


def test_freeze_pos_clips_on_all_gradients_and_freezes_the_update():
    """optax clips on the norm of ALL gradients, then zeroes the update of
    the `pos_layer*` leaves, and AdamW's decay does not touch them."""
    rng = np.random.default_rng(5)
    vals = _tree_vals(rng)
    tcfg = _tcfg("adamw", freeze=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, vals)
    tx = jstate.make_optimizer(tcfg, jparams)
    opt_state = tx.init(jparams)
    net = _Tree(vals)
    popt = pstate.make_optimizer(tcfg, net)
    jq, pq = jstate.GradNormQueue.create(), pstate.GradNormQueue("cpu")
    for step in range(3):
        g = _tree_vals(rng, scale=3000.0)          # above the threshold
        jg, jq, jn = jstate.clip_by_queue(
            jax.tree_util.tree_map(jnp.asarray, g), jq)
        upd, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for n, p in net.named_parameters():
            a, b = n.split(".")
            p.grad = _t(g[a][b])
        pn = pstate.clip_by_queue([p.grad for p in net.parameters()], pq)
        popt.step()
        assert float(pn) == pytest.approx(float(jn), rel=1e-6)
    frozen = net.pos_layer_with_edge["kernel"].detach().numpy()
    np.testing.assert_array_equal(frozen,
                                  vals["pos_layer_with_edge"]["kernel"])
    for n, p in net.named_parameters():
        a, b = n.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[a][b]), atol=1e-6,
                                   rtol=1e-6)
    assert pstate.trained_names(net, True) == ["node.kernel", "head.bias"]


# ------------------------------------------------------------- train steps

def _train_cfg(fused):
    jcfg = small_config(fused)
    jcfg.model.denoiser.num_layers = 2
    jcfg.train.batch_size = 3
    jcfg.train.dtype = "float32"
    jcfg.train.ema_decay = 0.9
    return jcfg


def test_three_train_steps_match_jax():
    """The JAX step (fused stack 'xla', the oracle of its Pallas path) and
    the port's ('pallas2') from the same parameters, on the draws the JAX
    step makes from each step's seed: parameters, EMA, queue, metrics."""
    jcfg = _train_cfg("xla")
    batch = next(iter(JLoader(jsynthetic(0, 3, max_atoms=12), jcfg, 3,
                              shuffle=False)))
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    jst = jstate.create_train_state(jcfg.train, params)
    jstep = jmake_train_step(jpg, jcfg, donate=False)

    # the port's state starts from the JAX TrainState itself
    pcfg = port_config(jcfg, "pallas2")
    pg = PhoreGen(pcfg)
    pst = pstate.create_train_state(pcfg.train, pg.net)
    from_jax_train_state(serialization.to_state_dict(jst), pst)
    pstep = make_train_step(pg, pcfg)
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    std = jcfg.train.lig_noise_std
    named = dict(pg.net.named_parameters())
    null = {n: torch.zeros_like(p, dtype=torch.bool)
            for n, p in named.items()}
    for seed in (np.uint32(7), np.uint32(8), np.uint32(9)):
        jst, jm = jstep(jst, seed, batch)
        draws = _jax_draws(jax.random.PRNGKey(seed), batch, std, jpg)
        pm = pstep(pst, seed, tb, **draws)
        # Adam scales whatever gradient an entry has up to a step of about
        # lr, so an entry whose true gradient is zero takes a full step in
        # a direction that is float32 rounding noise: the second bias of
        # each key MLP (a softmax does not see a bias added to every key),
        # the atom-count heads (their sigmoids saturate at the +-2 biases),
        # units behind a dead relu. Entries whose gradient is below 1e-6 of
        # the step's largest are left out of the parameter comparison.
        gmax = max(float(p.grad.abs().max()) for p in named.values())
        for n, p in named.items():
            null[n] |= p.grad.abs() < 1e-6 * gmax
        assert set(pm) == set(jm)
        for k in ("loss", "grad_norm", "loss_pos", "loss_node", "loss_edge"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=2e-4), k
    assert pst.step == int(jst.step) == 3
    assert pst.grad_queue.count == int(jst.grad_queue.count) == 4
    np.testing.assert_allclose(pst.grad_queue.values.numpy(),
                               np.asarray(jst.grad_queue.values), rtol=2e-4)
    n_null = sum(int(m.sum()) for m in null.values())
    assert n_null < 0.3 * sum(m.numel() for m in null.values()), n_null
    for tree, mine in ((jst.params, named), (jst.ema_params, pst.ema_params)):
        ref = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                  tree["params"]))
        assert set(ref) == set(mine)
        for k, r in ref.items():
            keep = ~null[k].numpy()
            np.testing.assert_allclose(mine[k].detach().numpy()[keep],
                                       r[keep], atol=1e-5, rtol=0, err_msg=k)
    # the parameters moved, and the EMA trails them
    init = flatten_tree(jax.tree_util.tree_map(np.asarray, params["params"]))
    k = "denoiser.layers.layer.lin_node.kernel"
    assert np.abs(named[k].detach().numpy() - init[k]).max() > 1e-5
    assert not np.allclose(pst.ema_params[k].numpy(),
                           named[k].detach().numpy())


def test_ema_off_leaves_the_shadow_and_eval_step_takes_a_graph_mask():
    jcfg = _train_cfg("xla")
    jcfg.train.ema = False
    pcfg = port_config(jcfg, "pallas2")
    pg = PhoreGen(pcfg)
    cfg_ds = get_dataset(pcfg, synthetic_size=8)[0]
    tb = next(iter(PhoreDataLoader(cfg_ds, pcfg, 4, shuffle=False))).to("cpu")
    st = pstate.create_train_state(pcfg.train, pg.net)
    before = {k: v.clone() for k, v in st.ema_params.items()}
    m = make_train_step(pg, pcfg)(st, 3, tb)
    assert np.isfinite(float(m["loss"])) and st.step == 1
    assert all(torch.equal(before[k], st.ema_params[k]) for k in before)
    ev = make_eval_step(pg, pcfg)
    full = ev(5, tb)
    # masking a duplicated tail: metrics of the first two graphs only
    dup = PhoreGraphBatch(**{k: torch.cat([v[:2], v[:2]])
                             for k, v in vars(tb).items()})
    draws = dict(t=torch.tensor([1, 6, 1, 6]))
    a = ev(5, dup, torch.tensor([True, True, False, False]), **draws)
    b = ev(5, dup, torch.tensor([True, True, True, True]), **draws)
    assert set(a) == set(full)
    assert np.isfinite(float(a["loss"])) and np.isfinite(float(b["loss"]))


def test_more_than_one_device_raises_and_names_the_roadmap(tmp_path,
                                                          monkeypatch):
    """Data parallelism is ported (it used to raise, naming ROADMAP.md):
    `train.num_devices` 2 on the CPU trains two gloo ranks through the
    CLI; more CUDA devices than are visible is a SystemExit naming both
    numbers; a `Run` whose `train.num_devices` is not its process group's
    world size refuses."""
    import yaml
    from phoregen_tpu_torch.cli import train as cli
    cfg = _run_cfg(tmp_path, "ranks", fused="none")
    cfg.train.num_devices = 2
    path = os.path.join(str(tmp_path), "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    hist = cli.main(["--config", path, "--epochs", "1", "--synthetic_size",
                     "8", "--device", "cpu"])
    assert len(hist["train"]) == 1 and np.isfinite(hist["train"][0]["loss"])
    assert os.path.exists(os.path.join(str(tmp_path), "ranks",
                                       "last_model.msgpack"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="2 CUDA devices, but 1 are "
                                         "visible"):
        cli.main(["--config", path, "--device", "cuda"])
    pcfg = port_config(_train_cfg("xla"), "pallas2")
    pcfg.train.num_devices = 4
    with pytest.raises(ValueError, match="one process per device"):
        ploop.Run(pcfg, run_dir=str(tmp_path / "unused"), device="cpu")


# ----------------------------------------------------------- Run, the CLI

def _run_cfg(tmp_path, name, fused="pallas2"):
    cfg = port_config(_train_cfg("xla"), fused)
    cfg.train.batch_size = 8
    cfg.train.optimizer.lr = 3e-3
    cfg.logger.result = str(tmp_path)
    cfg.logger.run_name = name
    cfg.logger.tensorboard = False
    return cfg


def test_run_trains_two_epochs_resumes_and_the_loss_falls(tmp_path):
    cfg = _run_cfg(tmp_path, "t")
    train, valid, _ = get_dataset(cfg, synthetic_size=24)
    run = ploop.Run(cfg, device="cpu")
    run.init_state()
    vb = next(iter(PhoreDataLoader(valid, cfg, 8, shuffle=False))).to("cpu")
    fixed_loss = lambda r: np.mean([float(r.eval_step(s, vb)["loss"])
                                    for s in (0, 1, 2)])
    before = fixed_loss(run)
    hist = run.train(train, valid, epochs=2)
    assert len(hist["train"]) == 2 and len(hist["valid"]) == 2
    assert np.isfinite(hist["valid"][-1]["loss"])
    assert all(np.isfinite(r["grad_norm"]) for r in hist["train"])
    # the loss of one validation batch on fixed draws fell
    assert fixed_loss(run) < 0.8 * before
    run_dir = os.path.join(str(tmp_path), "t")
    for f in ("last_model.msgpack", "last_model.json", "best_model.msgpack",
              "history.log", "parameters.yml", "model.conf"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    with open(os.path.join(run_dir, "history.log")) as f:
        assert json.load(f)["epoch"] == 1
    # resume: an in-place restart continues from epoch 2 with the state
    cfg2 = _run_cfg(tmp_path, "t")
    cfg2.logger.restart = "inplace"
    run2 = ploop.Run(cfg2, device="cpu")
    assert run2.logger.start_epoch == 2
    run2.init_state()
    assert run2.state.step == run.state.step == 6
    assert run2.state.grad_queue.count == run.state.grad_queue.count
    for (n, a), b in zip(run.state.net.named_parameters(),
                         run2.state.net.parameters()):
        assert torch.equal(a, b), n
    for p in run.state.net.parameters():
        s1 = run.state.optimizer.state[p]
        s2 = run2.state.optimizer.state[
            dict(run2.state.net.named_parameters())[
                [n for n, q in run.state.net.named_parameters()
                 if q is p][0]]]
        assert torch.equal(s1["exp_avg"], s2["exp_avg"])
        assert float(s1["step"]) == float(s2["step"]) == 6
        break
    hist2 = run2.train(train, valid, epochs=3)
    assert len(hist2["train"]) == 3
    # a run directory that exists is refused without a restart mode
    with pytest.raises(FileExistsError):
        ploop.Run(_run_cfg(tmp_path, "t"), device="cpu")


def test_cli_train_runs_on_the_cpu(tmp_path, capsys):
    import yaml
    from phoregen_tpu_torch.cli import train as cli
    cfg = _run_cfg(tmp_path, "cli", fused="none")
    path = os.path.join(str(tmp_path), "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg.to_dict(), f)
    assert cli.parse_args(["--config", path]).device == "cuda"
    hist = cli.main(["--config", path, "--epochs", "1", "--synthetic_size",
                     "8", "--device", "cpu"])
    assert len(hist["train"]) == 1 and np.isfinite(hist["train"][0]["loss"])
    assert "best valid loss" in capsys.readouterr().out
    assert os.path.exists(os.path.join(str(tmp_path), "cli",
                                       "best_model.msgpack"))
