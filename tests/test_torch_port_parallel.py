"""Data parallelism in the port (`phoregen_tpu_torch/parallel/group.py`)
against the JAX package's `data` mesh and against the port's own single
process, on the CPU: gloo ranks are spawned from the test
(`group.launch`), each launch joined within LAUNCH_TIMEOUT seconds so that
a hang fails instead of blocking the suite.

- Train steps at world size 2 against the port's single process on the
  global batch and against the JAX `make_train_step` on `make_mesh(2)`,
  from the same parameters on the same draws (the JAX step's, each rank
  keeping its rows). One case gives the ranks different numbers of valid
  atoms: a mean of per-rank means fails it. Tolerances: the two ranks
  bit for bit equal; world 2 against one process (the same arithmetic
  summed in another order): metrics 1e-5 relative, parameters 1e-5
  absolute; against the JAX mesh step: metrics 2e-4 relative and
  parameters 1e-5 absolute, as tests/test_torch_port_train.py holds one
  device (Adam's first steps move a parameter by about lr whatever its
  gradient, so entries whose gradient is rounding noise, below 1e-6 of
  the step's largest, are left out of the parameter comparison).
- `local_batch_slice` and the loader's per-rank batches against the JAX
  package's at world sizes 1, 2 and 4; the slices' union is the global
  batch, with augmentation too.
- A checkpoint written at world size 2 read at world size 1 and back,
  bit for bit; `Run.train` at world size 2 writes the history one
  process writes, from rank 0 only.
- The sharded sampling pool on ["cpu", "cpu"] (pool 8, and 7 rounded up
  to 8) equals the unsharded pool, and a shard's guidance gradient is
  its rows of the pool's.
"""
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
from phoregen_tpu.parallel import mesh as jmesh
from phoregen_tpu.train import state as jstate
from phoregen_tpu.train.step import make_train_step as jmake_train_step

from phoregen_tpu_torch.data.batching import PhoreGraphBatch
from phoregen_tpu_torch.data.dataset import get_dataset
from phoregen_tpu_torch.data.loader import PhoreDataLoader
from phoregen_tpu_torch.data.phore import parse_phore_text
from phoregen_tpu_torch.models.phoregen import PhoreGen
from phoregen_tpu_torch.parallel import group
from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
from phoregen_tpu_torch.sample.sampler import GuidanceOpt
from phoregen_tpu_torch.train import state as pstate
from phoregen_tpu_torch.train.checkpoint import (from_jax_train_state,
                                                 load_checkpoint,
                                                 save_checkpoint)
from phoregen_tpu_torch.train.step import make_eval_step, make_train_step

import torch_port_parallel_workers as workers
from test_torch_port_cli import small_port_model
from test_torch_port_loss import _jax_draws
from test_torch_port_model import port_config
from test_torch_port_sampler import PHORE_TEXT
from test_torch_port_train import _run_cfg, _train_cfg

LAUNCH_TIMEOUT = 120.0
SEEDS = (np.uint32(7), np.uint32(8), np.uint32(9))


def _np_batch(batch, rows=None):
    out = {k: np.asarray(v) for k, v in vars(batch).items()}
    return out if rows is None else {k: v[rows] for k, v in out.items()}


# ------------------------------------------------------------ train steps

# name: (JAX fused_stack, port fused_stack, the global batch's rows of a
# 4-graph loader batch)
STEP_CASES = {
    "pallas2_unequal_atoms": ("xla", "pallas2", [0, 1, 2, 3]),
    "module_equal_atoms": ("none", "none", [0, 1, 0, 1]),
}


@pytest.fixture(scope="module", params=sorted(STEP_CASES))
def step_case(request):
    jfused, pfused, rows = STEP_CASES[request.param]
    jcfg = _train_cfg(jfused)
    jcfg.train.batch_size = 4
    base = next(iter(JLoader(jsynthetic(0, 4, max_atoms=12), jcfg, 4,
                             shuffle=False)))
    batch = type(base)(**_np_batch(base, np.asarray(rows)))
    n_atoms = np.asarray(batch.lig_mask).sum(1)
    per_rank = n_atoms[:2].sum(), n_atoms[2:].sum()
    if request.param.endswith("unequal_atoms"):
        assert per_rank[0] != per_rank[1], n_atoms
    else:
        assert per_rank[0] == per_rank[1]
    jpg = JPhoreGen(jcfg)
    params = jpg.init_params(jax.random.PRNGKey(0), batch)
    jst0 = jstate.create_train_state(jcfg.train, params)
    state0 = jax.tree_util.tree_map(np.asarray,
                                    serialization.to_state_dict(jst0))
    draws = [{k: v.numpy() for k, v in _jax_draws(
        jax.random.PRNGKey(s), batch, jcfg.train.lig_noise_std, jpg
    ).items()} for s in SEEDS]

    # the JAX package on a 2-device mesh
    mesh = jmesh.make_mesh(2, "data")
    jstep = jmake_train_step(jpg, jcfg, mesh, donate=False)
    jst = jmesh.replicate(jst0, mesh)
    jbatch = jmesh.shard_batch(batch, mesh)
    jmetrics = []
    for s in SEEDS:
        jst, m = jstep(jst, s, jbatch)
        jmetrics.append({k: float(v) for k, v in m.items()})

    # the port, one process on the global batch; its gradients mark the
    # entries Adam moves by rounding noise
    pcfg = port_config(jcfg, pfused)
    pg = PhoreGen(pcfg)
    st = pstate.create_train_state(pcfg.train, pg.net)
    from_jax_train_state(state0, st)
    step = make_train_step(pg, pcfg)
    tb = PhoreGraphBatch(**_np_batch(batch)).to("cpu")
    named = dict(pg.net.named_parameters())
    null = {n: np.zeros(p.shape, bool) for n, p in named.items()}
    metrics = []
    for s, d in zip(SEEDS, draws):
        m = step(st, s, tb, **{k: torch.from_numpy(v) for k, v in d.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        gmax = max(float(p.grad.abs().max()) for p in named.values())
        for n, p in named.items():
            null[n] |= p.grad.abs().numpy() < 1e-6 * gmax
    gm = np.arange(4) % 3 != 1
    ev = make_eval_step(pg, pcfg)(5, tb, torch.from_numpy(gm),
                                  t=torch.from_numpy(draws[0]["t"]))
    # each half's own position loss at the initial parameters
    half_pg = PhoreGen(pcfg)
    from_jax_train_state(state0, pstate.create_train_state(pcfg.train,
                                                           half_pg.net))
    half_loss_pos = []
    for rows_h in (slice(0, 2), slice(2, 4)):
        with torch.no_grad():
            _, hm = half_pg.compute_loss(
                PhoreGraphBatch(**_np_batch(batch, rows_h)).to("cpu"), None,
                lig_noise_std=jcfg.train.lig_noise_std,
                **{k: torch.from_numpy(v[rows_h])
                   for k, v in draws[0].items()})
        half_loss_pos.append(float(hm["loss_pos"]))
    ranks = group.launch(workers.train_steps, 2,
                         (pcfg.to_dict(), state0, _np_batch(batch), SEEDS,
                          draws), timeout=LAUNCH_TIMEOUT)
    return dict(jst=jst, jmetrics=jmetrics, metrics=metrics,
                half_loss_pos=half_loss_pos,
                unequal=request.param.endswith("unequal_atoms"),
                state=workers.snapshot(st), null=null, ranks=ranks,
                eval={k: float(v) for k, v in ev.items()})


def _close_params(mine, ref, null, atol):
    for n, r in ref.items():
        keep = ~null[n]
        np.testing.assert_allclose(mine["params/" + n][keep], r[keep],
                                   atol=atol, rtol=0, err_msg=n)


def test_world_size_2_ranks_hold_one_state(step_case):
    a, b = (r["state"] for r in step_case["ranks"])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert step_case["ranks"][0]["metrics"] == step_case["ranks"][1][
        "metrics"]


def test_world_size_2_matches_one_process_on_the_global_batch(step_case):
    rank0 = step_case["ranks"][0]
    for mine, ref in zip(rank0["metrics"], step_case["metrics"]):
        assert set(mine) == set(ref)
        for k in ref:
            assert mine[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-7), k
    for k in step_case["eval"]:
        assert rank0["eval"][k] == pytest.approx(step_case["eval"][k],
                                                 rel=1e-5, abs=1e-7), k
    single = step_case["state"]
    _close_params(rank0["state"],
                  {k[7:]: v for k, v in single.items()
                   if k.startswith("params/")}, step_case["null"], 1e-5)
    np.testing.assert_allclose(rank0["state"]["queue"], single["queue"],
                               rtol=1e-5)
    assert int(rank0["state"]["step"]) == 3


def test_world_size_2_matches_the_jax_mesh_step(step_case):
    from phoregen_tpu_torch.utils.checkpoint import flatten_tree
    rank0 = step_case["ranks"][0]
    for mine, ref in zip(rank0["metrics"], step_case["jmetrics"]):
        assert set(mine) == set(ref)
        for k in ("loss", "grad_norm", "loss_pos", "loss_node", "loss_edge",
                  "loss_count"):
            assert mine[k] == pytest.approx(ref[k], rel=2e-4), k
    jst = step_case["jst"]
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                              jst.params["params"]))
    _close_params(rank0["state"], ref, step_case["null"], 1e-5)
    ema = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                              jst.ema_params["params"]))
    for n, r in ema.items():
        keep = ~step_case["null"][n]
        np.testing.assert_allclose(rank0["state"]["ema/" + n][keep], r[keep],
                                   atol=1e-5, rtol=0, err_msg=n)
    np.testing.assert_allclose(rank0["state"]["queue"],
                               np.asarray(jst.grad_queue.values), rtol=2e-4)
    assert int(rank0["state"]["queue_count"]) == int(jst.grad_queue.count)


def test_a_mean_of_per_rank_means_would_miss_the_global_loss(step_case):
    """What the unequal case guards: the mean of the two halves' own
    position losses (each half alone, the first step's draws) misses the
    global one by far more than the tolerance where their valid atom
    counts differ, and equals it where they do not."""
    halves = step_case["half_loss_pos"]
    glob = step_case["ranks"][0]["metrics"][0]["loss_pos"]
    assert glob == pytest.approx(step_case["metrics"][0]["loss_pos"],
                                 rel=1e-5)
    per_rank_mean = 0.5 * (halves[0] + halves[1])
    if step_case["unequal"]:
        assert abs(per_rank_mean - glob) > 1e-3 * abs(glob)
    else:
        assert per_rank_mean == pytest.approx(glob, rel=1e-5)


# ------------------------------------------------------------ batch slices

@pytest.mark.parametrize("world", [1, 2, 4])
def test_local_batch_slice_and_loader_rows_match_jax(world, monkeypatch):
    jcfg = _train_cfg("xla")
    pcfg = port_config(jcfg, "xla")
    samples = jsynthetic(0, 24, max_atoms=12)
    global_batches = list(PhoreDataLoader(samples, pcfg, 8, seed=3,
                                          augment=True).iter_with_sizes())
    parts = {}
    for r in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: r)
        monkeypatch.setattr(group, "world_size", lambda: world)
        monkeypatch.setattr(group, "rank", lambda: r)
        assert group.local_batch_slice(8) == jmesh.local_batch_slice(8)
        mine = list(PhoreDataLoader(samples, pcfg, 8, seed=3
                                    ).iter_with_sizes())
        ref = list(JLoader(samples, jcfg, 8, seed=3).iter_with_sizes())
        assert len(mine) == len(ref)
        for (b, real), (jb, jreal) in zip(mine, ref):
            assert real == jreal and b.num_graphs == 8 // world
            for k, v in vars(b).items():
                np.testing.assert_array_equal(v, np.asarray(getattr(jb, k)),
                                              err_msg=k)
        # with augmentation a rank's rows are those of the global batch
        parts[r] = list(PhoreDataLoader(samples, pcfg, 8, seed=3,
                                        augment=True).iter_with_sizes())
    for i, (gb, real) in enumerate(global_batches):
        assert all(parts[r][i][1] == real for r in range(world))
        for k, v in vars(gb).items():
            np.testing.assert_array_equal(
                np.concatenate([getattr(parts[r][i][0], k)
                                for r in range(world)]), v, err_msg=k)
    monkeypatch.setattr(group, "world_size", lambda: 3)
    with pytest.raises(AssertionError, match="not divisible"):
        group.local_batch_slice(8)


# ---------------------------------------------- checkpoints and Run.train

def test_checkpoint_round_trip_2_to_1_to_2(tmp_path):
    pcfg = port_config(_train_cfg("xla"), "pallas2")
    pcfg.train.batch_size = 4
    batch = next(iter(PhoreDataLoader(
        get_dataset(pcfg, synthetic_size=8)[0], pcfg, 4, shuffle=False)))
    nb = _np_batch(batch)
    ck = [str(tmp_path / f"ck{i}") for i in range(3)]
    first = group.launch(workers.checkpoint_round, 2,
                         (pcfg.to_dict(), None, ck[0], nb, 3),
                         timeout=LAUNCH_TIMEOUT)
    written = first[0]["written"]
    for k in written:   # both ranks stepped to the same state
        np.testing.assert_array_equal(first[1]["written"][k], written[k])
    # world size 1 reads what rank 0 wrote, bit for bit, and steps on
    pg = PhoreGen(pcfg)
    st = pstate.create_train_state(pcfg.train, pg.net)
    st, meta = load_checkpoint(ck[0], st)
    read = workers.snapshot(st)
    assert set(read) == set(written)
    for k in written:
        np.testing.assert_array_equal(read[k], written[k], err_msg=k)
    make_train_step(pg, pcfg)(st, 4, batch.to("cpu"))
    save_checkpoint(ck[1], st, 1, pcfg)
    one = workers.snapshot(st)
    # and world size 2 reads that on every rank, bit for bit
    second = group.launch(workers.checkpoint_round, 2,
                          (pcfg.to_dict(), ck[1], ck[2], nb, 5),
                          timeout=LAUNCH_TIMEOUT)
    for r in second:
        for k in one:
            np.testing.assert_array_equal(r["read"][k], one[k], err_msg=k)
    assert int(second[0]["written"]["step"]) == 3


def test_run_at_world_size_2_writes_the_history_of_one_process(tmp_path):
    """`Run.train` for two epochs at world size 2 and in one process: the
    same history (1e-5 relative; `time_cost` aside), rank 0 alone wrote
    the run directory, and the ranks end on one state after as many
    steps as the one process. (Parameters are not compared: over six
    Adam steps the entries whose gradient is rounding noise, such as a
    softmax key's bias, walk apart by up to lr a step.)"""
    cfg = _run_cfg(tmp_path, "one", fused="none")
    train, valid, _ = get_dataset(cfg, synthetic_size=24)
    single = __import__("phoregen_tpu_torch.train.loop",
                        fromlist=["Run"]).Run(cfg, device="cpu")
    hist1 = single.train(train, valid, epochs=2)
    cfg2 = _run_cfg(tmp_path, "two", fused="none")
    cfg2.train.num_devices = 2
    ranks = group.launch(workers.run_train, 2,
                         (cfg2.to_dict(), str(tmp_path / "two"), train,
                          valid, 2), timeout=LAUNCH_TIMEOUT)
    for r in ranks:
        for mode in ("train", "valid"):
            assert len(r["history"][mode]) == len(hist1[mode]) == 2
            for mine, ref in zip(r["history"][mode], hist1[mode]):
                for k, v in ref.items():
                    if k != "time_cost":
                        assert mine[k] == pytest.approx(v, rel=1e-5,
                                                        abs=1e-7), (mode, k)
    files = ranks[0]["files"]
    for f in ("last_model.msgpack", "best_model.msgpack", "history.log",
              "parameters.yml", "model.conf"):
        assert f in files, f
    with open(tmp_path / "two" / "history.log") as f:
        logged = json.load(f)
    assert logged["epoch"] == 1
    assert logged["history"]["train"][1]["loss"] == pytest.approx(
        hist1["train"][1]["loss"], rel=1e-5)
    assert int(ranks[0]["state"]["step"]) == single.state.step
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][k], v, err_msg=k)


# ----------------------------------------------------------- sampling pool

GUIDANCE = [GuidanceOpt(type="atom_prox", min_d=1.0, max_d=3.0),
            GuidanceOpt(type="center_prox")]


@pytest.mark.parametrize("pool", [8, 7])
def test_sharded_pool_equals_the_unsharded_pool(pool):
    """The JAX promise of tests/test_pipeline.py::
    test_mesh_parallel_pool_matches_single on two CPU shards: the same
    atom and bond types, positions within 1e-5; a pool of 7 is rounded up
    to 8 real members."""
    pg = small_port_model()
    phore = parse_phore_text(PHORE_TEXT, "p")
    single = GenerationPipeline(pg, guidance=GUIDANCE, device="cpu",
                                batch_size=8, seed=11, keep_traj=True)
    sharded = GenerationPipeline(pg, guidance=GUIDANCE, device="cpu",
                                 batch_size=8, seed=11, keep_traj=True,
                                 devices=["cpu", "cpu"])
    ps = single.prepare_phore(phore)
    lo, up = single._count_interval(ps)
    dec_s, raw_s = single.sample_pool(ps, 8, lo, up)
    dec_p, raw_p = sharded.sample_pool(ps, pool, lo, up)
    assert len(dec_s) == len(dec_p) == 8
    for k in ("pred_node", "pred_edge"):
        np.testing.assert_array_equal(raw_s[k].argmax(-1).numpy(),
                                      raw_p[k].argmax(-1).numpy(), err_msg=k)
    for k in ("node", "edge"):
        np.testing.assert_array_equal(raw_s["traj"][k].numpy(),
                                      raw_p["traj"][k].numpy(), err_msg=k)
    np.testing.assert_allclose(raw_s["pred_pos"].numpy(),
                               raw_p["pred_pos"].numpy(), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(dec_s, dec_p):
        np.testing.assert_array_equal(a["element"], b["element"])
        np.testing.assert_array_equal(a["bond_type"], b["bond_type"])
    # the next pool continues both generator streams alike
    _, raw_s2 = single.sample_pool(ps, 8, lo, up)
    _, raw_p2 = sharded.sample_pool(ps, 8, lo, up)
    np.testing.assert_allclose(raw_s2["pred_pos"].numpy(),
                               raw_p2["pred_pos"].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_a_shards_guidance_gradient_is_its_rows_of_the_pools():
    pg = small_port_model()
    pipe = GenerationPipeline(pg, guidance=GUIDANCE, device="cpu")
    ps = pipe.prepare_phore(parse_phore_text(PHORE_TEXT, "p"))
    from phoregen_tpu_torch.data.batching import replicate_phore
    B, NL = 6, 16
    counts = np.asarray([9, 12, 16, 10, 14, 11])
    batch = replicate_phore(ps, B, counts, NL).to("cpu")
    sampler = pipe.sampler
    inv = sampler.prepare(batch)
    g = torch.Generator().manual_seed(0)
    pos = 1.5 * torch.randn(B, NL, 3, generator=g)
    edge = torch.randint(0, 6, (B, NL, NL), generator=g)

    def grad(rows, pool_size):
        sub = PhoreGraphBatch(**{k: v[rows] for k, v in vars(batch).items()})
        p = pos[rows].clone().requires_grad_(True)
        e = sampler.energy(p, edge[rows], sub, inv["phore_center"][rows],
                           pool_size)
        return torch.autograd.grad(e, p)[0]
    whole = grad(slice(None), None)
    assert float(whole.abs().max()) > 0
    for rows in (slice(0, 3), slice(3, 6)):
        np.testing.assert_allclose(grad(rows, B).numpy(),
                                   whole[rows].numpy(), atol=1e-7, rtol=1e-6)
        # a shard that divided by its own size would pull twice as hard
        np.testing.assert_allclose(grad(rows, None).numpy(),
                                   2 * whole[rows].numpy(), atol=1e-7,
                                   rtol=1e-6)
