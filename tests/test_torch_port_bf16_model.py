"""Mixed precision in the port (`model.compute_dtype`, `train.dtype`
bfloat16) against the JAX package, and the EMA weights of a training
checkpoint (`--use_ema`):

- the whole network in bf16 ('xla2' with float32 and with bf16 blocks)
  against the JAX `PhoreDiffNet` on bf16 parameters and
  inputs: rtol = atol = 0.08, the JAX package's own bf16 bound
  (tests/test_layer_stack.py), with the same output dtypes;
- the loss and its gradients at `compute_dtype` bfloat16 against the JAX
  `compute_loss` on the same draws: loss within 2%, gradient norm within
  5%, gradients float32; the port's own bf16 loss within 5% of its float32
  loss (tests/test_train.py);
- one train step at `train.dtype` bfloat16 against `make_train_step`:
  loss within 2%, gradient norm within 5%, master parameters, gradients,
  Adam state and EMA float32;
- `cli.train` on a release configuration as it is (train.dtype bfloat16,
  fused_stack none), cut to a tiny width;
- the sampler casts its parameters once and samples in bf16;
- `--use_ema` samples a checkpoint's `ema_params`, and refuses where
  train.ema is false and on a release checkpoint.
Draws are injected: JAX's and torch's generators cannot match."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from phoregen_tpu.data.loader import PhoreDataLoader as JLoader
from phoregen_tpu.data.synthetic import synthetic_dataset as jsynthetic
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.train import state as jstate
from phoregen_tpu.train.step import make_train_step as jmake_train_step

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.models.diffusion_model import apply_net, cast_params
from phoregen_tpu_torch.models.phoregen import PhoreGen, load_release_model
from phoregen_tpu_torch.train import state as pstate
from phoregen_tpu_torch.train.checkpoint import from_jax_train_state
from phoregen_tpu_torch.train.step import make_train_step
from phoregen_tpu_torch.utils.checkpoint import (flatten_tree,
                                                 from_jax_params,
                                                 load_release)

from test_torch_port_loss import _jax_draws
from test_torch_port_model import _inputs, port_config, small_config

BF = torch.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASE = os.path.join(REPO, "release", "flagship_r4")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tb(batch):
    return PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                              vars(batch).items()}).to("cpu")


def _jbatch(jcfg, n=3):
    return next(iter(JLoader(jsynthetic(0, n, max_atoms=12), jcfg, n,
                             shuffle=False)))


# ------------------------------------------------------------ the network

# the module path's bf16 forward is held to the JAX package by
# tests/test_torch_port_module_variants.py::test_bfloat16_compute_raises
NETS = {   # name: (fused_stack, fused_block_dtype)
    "xla2": ("xla2", "float32"),
    "xla2_bf16_blocks": ("xla2", "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_bf16_network_matches_jax_bf16(name):
    fused, bdt = NETS[name]
    jcfg = small_config(fused)
    jcfg.model.compute_dtype = "bfloat16"
    jcfg.model.denoiser.fused_block_dtype = bdt
    batch = _jbatch(jcfg)
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    pg = PhoreGen(port_config(jcfg, fused))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    x = _inputs(batch)
    bf = jnp.bfloat16
    ref = jpg.net.apply(
        jax.tree_util.tree_map(lambda a: a.astype(bf), params),
        jnp.asarray(x["h_node"]).astype(bf), jnp.asarray(x["pos"]),
        batch.lig_mask, jnp.asarray(x["h_edge"]).astype(bf),
        jnp.asarray(x["t"]), jnp.asarray(batch.phore_x).astype(bf),
        batch.phore_pos, batch.phore_norm, batch.phore_mask)
    tb = _tb(batch)
    with torch.no_grad():
        out = apply_net(pg.net, cast_params(pg.net, BF),
                        _t(x["h_node"]).to(BF), _t(x["pos"]), tb.lig_mask,
                        _t(x["h_edge"]).to(BF), _t(x["t"]),
                        tb.phore_x.to(BF), tb.phore_pos, tb.phore_norm,
                        tb.phore_mask)
    lm = np.asarray(batch.lig_mask)
    bm = lm[:, :, None] & lm[:, None, :]
    for o, r, m in zip(out[:3], ref[:3], (lm, lm, bm)):
        assert str(o.dtype).split(".")[-1] == str(r.dtype)
        np.testing.assert_allclose(o.float().numpy()[m],
                                   np.asarray(r, np.float32)[m], atol=0.08,
                                   rtol=0.08)
    for o, r in zip(out[3], ref[3]):       # the count head stays float32
        assert o.dtype == torch.float32 and r.dtype == jnp.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=0.08,
                                   rtol=0.08)


# without bond diffusion the float32 pair-distance embedding promotes h_edge
# to float32 in the JAX package: name -> (JAX fused_stack, port fused_stack,
# scan_layers)
NO_BOND = {
    "xla2": ("xla2", "xla2", True),
    "pallas": ("xla", "pallas", True),
    "module_unscanned": ("none", "none", False),
}


@pytest.mark.parametrize("name", sorted(NO_BOND))
def test_bf16_without_bond_diffusion_promotes_h_edge_as_jax(name):
    """compute_dtype bfloat16, bond_diffusion false: h_edge reaches the
    denoiser in float32 and equal to the JAX package's h_edge (1e-6: a
    bf16 cast of the distance embedding misses by ~1e-2), and the network
    agrees with the JAX forward within its bf16 bound (rtol = atol = 0.08)
    with the same output dtypes (the unscanned module path turns float32
    after its first layer, as in the JAX package)."""
    jfused, pfused, scan = NO_BOND[name]
    jcfg = small_config(jfused)
    jcfg.model.compute_dtype = "bfloat16"
    jcfg.model.bond_diffusion = False
    jcfg.model.denoiser.scan_layers = scan
    batch = _jbatch(jcfg)
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    pg = PhoreGen(port_config(jcfg, pfused))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    x = _inputs(batch)
    bf = jnp.bfloat16
    bparams = jax.tree_util.tree_map(lambda a: a.astype(bf), params)
    pos = jnp.asarray(x["pos"])

    def jax_h_edge(m, pos, t):
        d = pos[:, None, :, :] - pos[:, :, None, :]
        emb = m.distance_embedding(
            jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True) + 1e-12))
        t_emb = m._time_embed(t).astype(bf)
        return jnp.concatenate([emb, jnp.broadcast_to(
            t_emb[:, None, None, :], emb.shape[:3] + t_emb.shape[-1:])], -1)
    ref_edge = jpg.net.apply(bparams, pos, jnp.asarray(x["t"]),
                             method=jax_h_edge)
    assert ref_edge.dtype == jnp.float32
    ref = jpg.net.apply(
        bparams, jnp.asarray(x["h_node"]).astype(bf), pos, batch.lig_mask,
        jnp.asarray(x["h_edge"]).astype(bf), jnp.asarray(x["t"]),
        jnp.asarray(batch.phore_x).astype(bf), batch.phore_pos,
        batch.phore_norm, batch.phore_mask)
    tb = _tb(batch)
    seen = {}
    hook = pg.net.denoiser.register_forward_pre_hook(
        lambda m, a: seen.update(h_edge=a[2]))
    with torch.no_grad():
        out = apply_net(pg.net, cast_params(pg.net, BF),
                        _t(x["h_node"]).to(BF), _t(x["pos"]), tb.lig_mask,
                        _t(x["h_edge"]).to(BF), _t(x["t"]),
                        tb.phore_x.to(BF), tb.phore_pos, tb.phore_norm,
                        tb.phore_mask)
    hook.remove()
    assert seen["h_edge"].dtype == torch.float32
    np.testing.assert_allclose(seen["h_edge"].numpy(), np.asarray(ref_edge),
                               atol=1e-6, rtol=1e-6)
    assert out[2] is None and ref[2] is None
    lm = np.asarray(batch.lig_mask)
    for o, r in zip(out[:2], ref[:2]):
        assert str(o.dtype).split(".")[-1] == str(r.dtype)
        np.testing.assert_allclose(o.float().numpy()[lm],
                                   np.asarray(r, np.float32)[lm], atol=0.08,
                                   rtol=0.08)


def test_bf16_without_bond_diffusion_scanned_module_path_refuses():
    """The scanned module path cannot carry the promoted h: the JAX
    package's nn.scan raises, and so does the port, naming the way out."""
    jcfg = small_config("none")
    jcfg.model.compute_dtype = "bfloat16"
    jcfg.model.bond_diffusion = False
    batch = _jbatch(jcfg)
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    x = _inputs(batch)
    bf = jnp.bfloat16
    with pytest.raises(TypeError, match="carry"):
        jpg.net.apply(
            jax.tree_util.tree_map(lambda a: a.astype(bf), params),
            jnp.asarray(x["h_node"]).astype(bf), jnp.asarray(x["pos"]),
            batch.lig_mask, jnp.asarray(x["h_edge"]).astype(bf),
            jnp.asarray(x["t"]), jnp.asarray(batch.phore_x).astype(bf),
            batch.phore_pos, batch.phore_norm, batch.phore_mask)
    pg = PhoreGen(port_config(jcfg, "none"))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    tb = _tb(batch)
    with pytest.raises(ValueError, match="scan_layers false"):
        apply_net(pg.net, cast_params(pg.net, BF), _t(x["h_node"]).to(BF),
                  _t(x["pos"]), tb.lig_mask, _t(x["h_edge"]).to(BF),
                  _t(x["t"]), tb.phore_x.to(BF), tb.phore_pos,
                  tb.phore_norm, tb.phore_mask)


# ---------------------------------------------------------------- the loss

def _global_norm(grads):
    return float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                             for g in grads)))


@pytest.mark.parametrize("fused", ["module", "pallas2"])
def test_bf16_loss_and_gradients_match_jax_bf16(fused):
    jfused, pfused = ("none", "none") if fused == "module" \
        else ("xla", "pallas2")
    jcfg = small_config(jfused)
    jcfg.model.denoiser.num_layers = 2
    batch = _jbatch(jcfg)
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    key = jax.random.PRNGKey(21)
    std = 0.1
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpg.compute_loss(p, key, batch, lig_noise_std=std,
                                   compute_dtype="bfloat16"),
        has_aux=True))(params)
    pg = PhoreGen(port_config(jcfg, pfused))
    pg.net.load_state_dict(from_jax_params(params), strict=True)
    draws = _jax_draws(key, batch, std, jpg)
    losses = {}
    for dt in ("float32", "bfloat16"):
        pg.net.zero_grad(set_to_none=True)
        loss, metrics = pg.compute_loss(_tb(batch), None, lig_noise_std=std,
                                        compute_dtype=dt, **draws)
        assert all(v.dtype == torch.float32 for v in metrics.values())
        loss.backward()
        losses[dt] = float(loss.detach())
    assert losses["bfloat16"] == pytest.approx(float(jloss), rel=0.02)
    # same math, reduced mantissa: a few % at init-scale losses
    assert abs(losses["bfloat16"] - losses["float32"]) \
        < 0.05 * abs(losses["float32"])
    named = dict(pg.net.named_parameters())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in named.values())
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jgrads["params"]))
    assert set(ref) == set(named)
    pnorm = _global_norm([p.grad.numpy() for p in named.values()])
    assert pnorm == pytest.approx(_global_norm(ref.values()), rel=0.05)


def test_bf16_train_step_matches_jax():
    """One step of the JAX trainer and of the port's at train.dtype
    bfloat16 from the same state, on the draws the JAX step makes."""
    jcfg = small_config("xla")
    jcfg.model.denoiser.num_layers = 2
    jcfg.train.batch_size = 3
    jcfg.train.dtype = "bfloat16"
    jcfg.train.ema_decay = 0.9
    batch = _jbatch(jcfg)
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    jst = jstate.create_train_state(jcfg.train, params)
    pcfg = port_config(jcfg, "pallas2")
    assert pcfg.train.dtype == "bfloat16"
    pg = PhoreGen(pcfg)
    pst = pstate.create_train_state(pcfg.train, pg.net)
    from_jax_train_state(serialization.to_state_dict(jst), pst)
    seed = np.uint32(7)
    jst, jm = jmake_train_step(jpg, jcfg, donate=False)(jst, seed, batch)
    draws = _jax_draws(jax.random.PRNGKey(seed), batch,
                       jcfg.train.lig_noise_std, jpg)
    pm = make_train_step(pg, pcfg)(pst, seed, _tb(batch), **draws)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=0.02)
    assert float(pm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=0.05)
    for p in pst.net.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        for v in pst.optimizer.state[p].values():
            assert not v.is_floating_point() or v.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in pst.ema_params.values())
    for leaf in jax.tree_util.tree_leaves(jst.params):
        assert leaf.dtype == jnp.float32


# ----------------------------------------------------- the CLIs on the CPU

def _tiny_release_config(tmp_path, name):
    """release/flagship_r4's configuration as it is (train.dtype bfloat16,
    fused_stack none, triplet_knn 32, scan_layers), cut to a tiny width
    and depth; nothing else changed."""
    with open(RELEASE + ".json") as f:
        raw = json.load(f)["config"]
    m = raw["model"]
    m["hidden_dim"] = m["denoiser"]["hidden_dim"] = 16
    m["denoiser"].update(num_layers=2, n_heads=2, knn=4, triplet_width=8)
    m["diff"].update(num_timesteps=8, time_dim=2)
    raw["dataset"].update(ligand_buckets=[16], max_phore=16,
                          corpus="chains", max_atom=12)
    raw["train"].update(batch_size=4, num_workers=0)
    raw["logger"].update(result=str(tmp_path), run_name=name,
                         tensorboard=False, restart="none")
    return raw


def test_cli_train_runs_a_release_config_in_bf16(tmp_path, capsys):
    import yaml
    from phoregen_tpu_torch.cli import train as cli
    raw = _tiny_release_config(tmp_path, "bf16")
    assert raw["train"]["dtype"] == "bfloat16"
    assert raw["model"]["denoiser"]["fused_stack"] == "none"
    path = os.path.join(str(tmp_path), "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    hist = cli.main(["--config", path, "--epochs", "1", "--synthetic_size",
                     "8", "--device", "cpu"])
    assert len(hist["train"]) == 1 and np.isfinite(hist["train"][0]["loss"])
    assert "best valid loss" in capsys.readouterr().out
    run_dir = os.path.join(str(tmp_path), "bf16")
    for f in ("last_model.msgpack", "last_model.json", "best_model.msgpack",
              "history.log", "parameters.yml"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    with open(os.path.join(run_dir, "last_model.json")) as f:
        assert json.load(f)["config"]["train"]["dtype"] == "bfloat16"


def test_sampler_casts_once_and_samples_in_bf16():
    from phoregen_tpu_torch.data.batching import replicate_phore
    from phoregen_tpu_torch.data.phore import parse_phore_text
    from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
    from test_torch_port_sampler import PHORE_TEXT
    cfg = port_config(small_config("xla"), "pallas2")
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.denoiser.fused_block_dtype = "bfloat16"
    pg = PhoreGen(cfg)
    pipe = GenerationPipeline(pg, batch_size=2, seed=0, device="cpu")
    sample = pipe.prepare_phore(parse_phore_text(PHORE_TEXT, "bf"))
    batch = replicate_phore(sample, 2, np.asarray([6, 9]), 16).to("cpu")
    sp = pipe.sampler
    inv = sp.prepare(batch)
    assert inv["dtype"] == BF
    assert all(v.dtype == BF for v in inv["params"].values())
    assert inv["h_phore"].dtype == BF
    assert all(v.dtype == torch.float32 for v in inv["packed"].values())
    state = sp.init_state(batch, torch.Generator().manual_seed(0))
    new, preds = sp.step(state, 0, batch, inv, False,
                         torch.Generator().manual_seed(1))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all()
               for p in preds)
    assert new["pos"].dtype == torch.float32
    # the master parameters are untouched float32
    assert all(p.dtype == torch.float32 for p in pg.net.parameters())


def _train_checkpoint(tmp_path, name, ema: bool):
    """A checkpoint written by the port's trainer (one tiny epoch)."""
    from phoregen_tpu_torch.data.dataset import get_dataset
    from phoregen_tpu_torch.train import loop as ploop
    raw = _tiny_release_config(tmp_path, name)
    raw["train"].update(ema=ema, ema_decay=0.5, dtype="float32")
    cfg = config_from_dict(raw)
    train, valid, _ = get_dataset(cfg, synthetic_size=8)
    run = ploop.Run(cfg, device="cpu")
    run.init_state()
    run.train(train, valid, epochs=1)
    return os.path.join(str(tmp_path), name, "last_model"), run.state


def test_use_ema_samples_the_ema_params(tmp_path):
    prefix, state = _train_checkpoint(tmp_path, "ema_on", ema=True)
    tree, _ = load_release(prefix, use_ema=True)
    ema = from_jax_params(tree)
    params = dict(state.net.named_parameters())
    assert set(ema) == set(params)
    moved = 0
    for k, v in ema.items():
        np.testing.assert_array_equal(v.numpy(),
                                      state.ema_params[k].numpy())
        moved += not torch.equal(v, params[k].detach())
    assert moved > 0          # the shadow is not the parameters
    pg, _ = load_release_model(prefix, device="cpu", use_ema=True)
    for k, p in pg.net.named_parameters():
        assert torch.equal(p.detach(), state.ema_params[k]), k
    pg2, _ = load_release_model(prefix, device="cpu")
    for k, p in pg2.net.named_parameters():
        assert torch.equal(p.detach(), params[k].detach()), k


def test_use_ema_refuses_ema_off_and_release_checkpoints(tmp_path):
    from phoregen_tpu_torch.cli import sample as cli
    prefix, _ = _train_checkpoint(tmp_path, "ema_off", ema=False)
    base = ["--phore", "none.phore", "--device", "cpu", "--result_path",
            str(tmp_path), "--use_ema"]
    with pytest.raises(SystemExit, match="train.ema=false"):
        cli.main(["--ckpt", prefix] + base)
    with pytest.raises(SystemExit, match="bare model weights"):
        cli.main(["--ckpt", RELEASE] + base)
    with pytest.raises(ValueError, match="bare model weights"):
        load_release(RELEASE, use_ema=True)
    # with EMA on the CLI gets past the weights and fails only on the
    # missing pharmacophore file
    on, _ = _train_checkpoint(tmp_path, "ema_on2", ema=True)
    with pytest.raises(FileNotFoundError, match="none.phore"):
        cli.main(["--ckpt", on] + base)
