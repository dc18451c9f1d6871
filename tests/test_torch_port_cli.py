"""The port's whole single-device sampling entry point beyond the release
path: reference `.pt` checkpoints (`utils/torch_import.py`) against the
JAX package's importer on the same `torch.save` file, the native host
library against the Python bond perception and valence check, and the
pipeline's options (`chunk_steps`, `recon_workers`, `save_pool`, the
out-of-memory retry) and the CLI that drives them, on the CPU.

Tolerances: imported trees exactly, leaf by leaf; the forward on imported
weights 1e-5 (atol = rtol, float32 on identical inputs); chunked sampling
bit for bit."""
import argparse
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phoregen_tpu.config import default_config as jdefault_config
from phoregen_tpu.data.loader import PhoreDataLoader
from phoregen_tpu.data.synthetic import synthetic_dataset
from phoregen_tpu.models.phoregen import PhoreGen as JPhoreGen
from phoregen_tpu.sample import pipeline as jpipeline
from phoregen_tpu.utils import torch_import as jti

from phoregen_tpu_torch import native
from phoregen_tpu_torch.config import config_from_dict, default_config
from phoregen_tpu_torch.constants import ATOMIC_NUMBERS
from phoregen_tpu_torch.data.batching import PhoreGraphBatch, \
    replicate_phore
from phoregen_tpu_torch.data.phore import parse_phore_file, \
    parse_phore_text
from phoregen_tpu_torch.data.synthetic import random_molecule
from phoregen_tpu_torch.models.phoregen import (PhoreGen, init_params,
                                                load_reference_model)
from phoregen_tpu_torch.sample import predict_bonds as pb
from phoregen_tpu_torch.sample.chem import (SimpleMol, is_connected,
                                            sanitize_simple)
from phoregen_tpu_torch.sample.decode import decode_batch
from phoregen_tpu_torch.sample.pipeline import GenerationPipeline
from phoregen_tpu_torch.sample.sampler import GuidanceOpt, Sampler
from phoregen_tpu_torch.utils import torch_import as pti
from phoregen_tpu_torch.utils.checkpoint import flatten_tree

from test_torch_import import _build_reference_state
from test_torch_port_sampler import PHORE_TEXT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(atol=1e-5, rtol=1e-5)
GUIDANCE = [GuidanceOpt(type="atom_prox", min_d=1.0, max_d=3.0),
            GuidanceOpt(type="center_prox")]


class EasyDict(dict):
    """A dict with attribute access, pickled as the upstream project's
    `easydict.EasyDict` config is (a dict subclass with a __dict__)."""

    def __init__(self, d=None):
        super().__init__(d or {})
        for k, v in self.items():
            setattr(self, k, v)


class _RunsACommand:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (os.system, (f"touch {self.path}",))


# ------------------------------------------------------ reference .pt files

def dense_config(scan_layers=False):
    """A small reference-architecture configuration (the dense triplet
    parameterization), as tests/test_torch_import.py builds it."""
    cfg = jdefault_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 16
    m.denoiser.num_layers = 2
    m.denoiser.n_heads = 2
    m.denoiser.knn = 4
    m.denoiser.triplet_mode = "dense"
    m.denoiser.scan_layers = scan_layers
    m.diff.num_timesteps = 8
    m.diff.time_dim = 2
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.dataset.corpus = "chains"
    return cfg.finalize()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A reference-named state dict of seeded weights written with
    `torch.save` beside an argparse config object, its epoch and its best
    loss (the JAX package's reader stubs the config, as the port's does)."""
    jcfg = dense_config()
    batch = next(iter(PhoreDataLoader(synthetic_dataset(0, 2, max_atoms=12),
                                      jcfg, 2, shuffle=False)))
    params = JPhoreGen(jcfg).init_params(jax.random.PRNGKey(0), batch)
    host = jax.tree_util.tree_map(np.asarray, params)
    state = {k: torch.from_numpy(np.array(v))
             for k, v in _build_reference_state(host, jcfg).items()}
    path = str(tmp_path_factory.mktemp("pt") / "ref.pt")
    torch.save({"model": state, "epoch": 42, "best_loss": 1.5,
                "config": argparse.Namespace(lr=1e-4, layers=2)}, path)
    return dict(jcfg=jcfg, batch=batch, params=params, host=host,
                state=state, path=path)


@pytest.mark.parametrize("scan_layers", [False, True])
def test_pt_import_equals_the_jax_importer(reference, scan_layers):
    """The port's restricted `torch.load` + `map_reference_state` give the
    JAX importer's tree leaf by leaf, exactly, and its metadata; with
    `scan_layers` both stack the layers."""
    jcfg = dense_config(scan_layers)
    want, wmeta = jti.load_reference_checkpoint(reference["path"], jcfg)
    got, gmeta = pti.load_reference_checkpoint(
        reference["path"], config_from_dict(jcfg.to_dict()))
    assert gmeta == wmeta == {"epoch": 42, "best_loss": 1.5}
    fw, fg = flatten_tree(want["params"]), flatten_tree(got["params"])
    assert set(fw) == set(fg)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)
    if scan_layers:
        assert fg["denoiser.layers.layer.lin_node.kernel"].shape[0] == 2
    else:
        # the tree is the flax one the weights came from
        ref = flatten_tree(reference["host"]["params"])
        assert set(ref) == set(fg)
        for k in ref:
            np.testing.assert_array_equal(fg[k], ref[k], err_msg=k)


def test_forward_on_imported_weights_matches_jax(reference):
    jcfg, batch = reference["jcfg"], reference["batch"]
    jparams, _ = jti.load_reference_checkpoint(reference["path"], jcfg)
    pg, meta = load_reference_model(reference["path"],
                                    config_from_dict(jcfg.to_dict()),
                                    device="cpu")
    assert meta["epoch"] == 42
    B, NL = batch.lig_type.shape
    rng = np.random.default_rng(5)
    x = dict(h_node=rng.normal(size=(B, NL, 12)).astype(np.float32),
             h_edge=rng.normal(size=(B, NL, NL, 6)).astype(np.float32),
             pos=(np.asarray(batch.lig_pos) + 0.1 * rng.normal(
                 size=batch.lig_pos.shape)).astype(np.float32),
             t=rng.integers(0, 8, size=(B,)).astype(np.int32))
    ref = jax.jit(JPhoreGen(jcfg).net.apply)(
        jax.tree_util.tree_map(jnp.asarray, jparams),
        jnp.asarray(x["h_node"]), jnp.asarray(x["pos"]), batch.lig_mask,
        jnp.asarray(x["h_edge"]), jnp.asarray(x["t"]), batch.phore_x,
        batch.phore_pos, batch.phore_norm, batch.phore_mask)
    tb = PhoreGraphBatch(**{k: np.asarray(v) for k, v in
                            vars(batch).items()}).to("cpu")
    T = torch.from_numpy
    with torch.no_grad():
        out = pg.net(T(x["h_node"]), T(x["pos"]), tb.lig_mask,
                     T(x["h_edge"]), T(x["t"]), tb.phore_x, tb.phore_pos,
                     tb.phore_norm, tb.phore_mask)
    lm = np.asarray(batch.lig_mask)
    bm = lm[:, :, None] & lm[:, None, :]
    for a, b, m in zip(out[:3], ref[:3], (lm, lm, bm)):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], **FWD)
    for a, b in zip(out[3], ref[3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


def test_pt_import_refuses_what_it_cannot_map(reference, tmp_path):
    """A missing tensor raises, a factorized config raises (its weights
    have no reference form), and so does an unconsumed tensor."""
    cfg = config_from_dict(reference["jcfg"].to_dict())
    state = {k: v.numpy() for k, v in reference["state"].items()}
    bad = dict(state)
    bad.pop("denoiser.base_block.1.lin_node.weight")
    with pytest.raises((KeyError, ValueError)):
        pti.map_reference_state(bad, cfg)
    extra = dict(state, **{"denoiser.extra.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="not mapped"):
        pti.map_reference_state(extra, cfg)
    fact = config_from_dict(reference["jcfg"].to_dict())
    fact.model.denoiser.triplet_mode = "factorized"
    with pytest.raises(ValueError, match="dense"):
        pti.load_reference_checkpoint(reference["path"], fact)
    # a DataParallel prefix is stripped
    path = str(tmp_path / "dp.pt")
    torch.save({"module." + k: v for k, v in reference["state"].items()},
               path)
    tree, meta = pti.load_reference_checkpoint(path, cfg)
    assert meta == {} and "denoiser" in tree["params"]


def test_pt_pickle_names_run_nothing(reference, tmp_path):
    """Every name beyond torch's rebuild functions, OrderedDict, plain
    builtins and numpy arrays becomes an inert stub: a pickled `os.system`
    call is not made, `eval` is not handed out, and an EasyDict-style
    config (a dict subclass) loads as a stub holding its items."""
    marker = tmp_path / "ran"
    path = str(tmp_path / "evil.pt")
    torch.save({"model": reference["state"], "epoch": 3,
                "config": EasyDict({"lr": 1e-4, "layers": [1, 2]}),
                "payload": _RunsACommand(str(marker)), "fn": eval,
                "kinds": {1, 2}}, path)
    obj = pti.read_torch_pt(path)
    assert not marker.exists()
    assert isinstance(obj["payload"], pti._Stub)
    assert obj["payload"].args == (f"touch {marker}",)
    assert obj["fn"] is pti._Stub
    assert obj["config"].items == {"lr": 1e-4, "layers": [1, 2]}
    assert obj["kinds"] == {1, 2}
    cfg = config_from_dict(reference["jcfg"].to_dict())
    tree, meta = pti.load_reference_checkpoint(path, cfg)
    assert meta == {"epoch": 3} and not marker.exists()
    # the same through the unpickler alone, on a plain pickle
    with open(tmp_path / "plain.pkl", "wb") as f:
        pickle.dump([_RunsACommand(str(marker)), eval], f)
    with open(tmp_path / "plain.pkl", "rb") as f:
        stub, fn = pti._RestrictedUnpickler(f).load()
    assert isinstance(stub, pti._Stub) and fn is not eval
    assert not marker.exists()


def test_cli_samples_a_reference_checkpoint(reference, tmp_path):
    import yaml
    from phoregen_tpu_torch.cli import sample as cli
    cfg_path = str(tmp_path / "ref.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(reference["jcfg"].to_dict(), f)
    phore = tmp_path / "p.phore"
    phore.write_text(PHORE_TEXT)
    base = ["--ckpt", reference["path"], "--phore", str(phore),
            "--device", "cpu", "--result_path", str(tmp_path / "out"),
            "--num_samples", "2", "--batch_size", "2", "--max_batches", "1"]
    with pytest.raises(SystemExit, match="requires --config"):
        cli.main(base)
    with pytest.raises(SystemExit, match="bare model weights"):
        cli.main(base + ["--config", cfg_path, "--use_ema"])
    out = cli.main(base + ["--config", cfg_path, "--save_pool"])
    res, = out["results"]
    assert res["n_sampled"] == 2
    assert os.path.exists(tmp_path / "out" / "pipe_phore" /
                          "pipe_phore_samples_all.npz")


# ------------------------------------------------------------ native host

def test_native_library_matches_python_and_builds_in_the_port(tmp_path):
    """`predict_bonds_native` and `check_mol_native` against the Python
    versions on the cases of tests/test_native.py; the library builds
    into `phoregen_tpu_torch/_build/` (a fresh build in a subprocess that
    imports neither torch nor the JAX package) and nothing under
    `phoregen_tpu/` changes (apart from the JAX package's own build of its
    library, which its tests may make meanwhile)."""
    def snapshot():
        out = {}
        for d, dirs, files in os.walk(os.path.join(ROOT, "phoregen_tpu")):
            dirs[:] = [x for x in dirs if x != "__pycache__"]
            for f in files:
                if f.startswith("libphoregen_host.so"):
                    continue
                p = os.path.join(d, f)
                st = os.stat(p)
                out[p] = (st.st_size, st.st_mtime_ns)
        return out

    before = snapshot()
    code = ("import sys; from phoregen_tpu_torch import native; "
            f"native.BUILD_DIR = {str(tmp_path)!r}; "
            "assert native.available(), native.load_error(); "
            "import phoregen_tpu_torch.sample.reconstruct; "
            "print(native.library_path()); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'phoregen_tpu', 'jax')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    lib, mods = res.stdout.strip().splitlines()
    assert mods == "[]"
    assert os.path.dirname(lib) == str(tmp_path) and os.path.exists(lib)
    assert native.available(), native.load_error()
    assert os.path.dirname(native.library_path()) == os.path.join(
        ROOT, "phoregen_tpu_torch", "_build")

    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(2, 24))
        types, pos, _, _ = random_molecule(rng, n)
        elements = [ATOMIC_NUMBERS[t] for t in types]
        got = native.predict_bonds_native(elements, pos)
        want = pb.predict_bonds_python(elements, pos)
        assert got[0] == want[0] and got[1] == want[1], trial
        assert pb.predict_bonds(elements, pos) == got
    rng = np.random.default_rng(1)
    for trial in range(20):
        n = int(rng.integers(2, 20))
        types, pos, bidx, battr = random_molecule(rng, n)
        elements = [ATOMIC_NUMBERS[t] for t in types]
        mol = SimpleMol(elements, pos, bidx, battr)
        got = native.check_mol_native(elements, mol.undirected_bonds())
        assert got == (sanitize_simple(mol), is_connected(mol)), trial
    assert native.check_mol_native([6, 6], []) == (True, False)
    assert native.check_mol_native(
        [6] * 6, [(0, i, 1) for i in range(1, 6)])[0] is False
    assert native.check_mol_native([6, 6], [(0, 1, 4)])[0] is False
    with pytest.raises(ValueError, match="out of range"):
        native.check_mol_native([6, 6], [(0, 2, 1)])
    assert snapshot() == before


# --------------------------------------------------------------- pipeline

def small_port_model(seed=0, **model):
    cfg = default_config("zinc_300")
    m = cfg.model
    m.hidden_dim = m.denoiser.hidden_dim = 16
    m.denoiser.num_layers = 1
    m.denoiser.n_heads = 2
    m.denoiser.knn = 4
    m.denoiser.triplet_knn = 3
    m.denoiser.triplet_width = 8
    m.denoiser.fused_stack = "none"
    m.diff.num_timesteps = 10
    m.diff.time_dim = 2
    for k, v in model.items():
        setattr(m, k, v)
    cfg.dataset.ligand_buckets = [16]
    cfg.dataset.max_phore = 16
    cfg.finalize()
    pg = PhoreGen(cfg)
    init_params(pg.net, seed)
    pg.net.eval()
    return pg


def test_chunked_sampling_is_bit_identical():
    """`chunk_steps` 3 against one pass: every output, the trajectories
    and the generator's state after the chain are equal bit for bit."""
    pg = small_port_model()
    pipe = GenerationPipeline(pg, device="cpu")
    sample = pipe.prepare_phore(parse_phore_text(PHORE_TEXT, "p"))
    batch = replicate_phore(sample, 3, np.asarray([5, 9, 12]), 16).to("cpu")
    outs, states = [], []
    for chunk in (0, 3):
        sp = Sampler(pg, GUIDANCE, keep_traj=True)
        gen = torch.Generator().manual_seed(11)
        outs.append(sp.sample(batch, gen, chunk_steps=chunk) if chunk == 0
                    else sp.sample_chunked(batch, chunk, gen))
        states.append(gen.get_state())
    a, b = outs
    assert torch.equal(states[0], states[1])
    for k in ("pred_node", "pred_pos", "pred_edge", "lig_mask"):
        assert torch.equal(a[k], b[k]), k
    for part in ("final_state", "traj"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["traj"]["pos"].shape[0] == 11
    with pytest.raises(ValueError):
        Sampler(pg).sample_chunked(batch, 0)


def _decoded_pool(n, seed=3, NL=16):
    """Padded one-hot arrays of `n` random chain molecules (with a few
    impossible valences among them) and their decoding: a sampler's raw
    output as the pipeline sees it."""
    rng = np.random.default_rng(seed)
    node = np.zeros((n, NL, 12), np.float32)
    node[..., 11] = 1.0
    edge = np.zeros((n, NL, NL, 6), np.float32)
    edge[..., 0] = 1.0
    pos = np.zeros((n, NL, 3), np.float32)
    mask = np.zeros((n, NL), bool)
    for b in range(n):
        k = int(rng.integers(4, NL))
        types, p, bidx, battr = random_molecule(rng, k)
        node[b, :k] = np.eye(12)[types]
        pos[b, :k] = p
        mask[b, :k] = True
        for (i, j), o in zip(bidx.T, battr):
            edge[b, i, j] = np.eye(6)[3 if b % 4 == 3 else o]
    raw = dict(pred_node=node, pred_pos=pos, pred_edge=edge, lig_mask=mask)
    return decode_batch(node, pos, edge, mask, include_bond=True), raw


def _fixed_pool(pipe, decoded, raw):
    """Replace the pipeline's sampling by `decoded` / `raw` (torch)."""
    def sample_pool(phore_sample, n, lower, upper):
        pipe.last_bucket = 16
        return [dict(d) for d in decoded[:n]], {
            k: torch.from_numpy(v[:n]) for k, v in raw.items()}
    pipe.sample_pool = sample_pool
    pipe._count_interval = lambda sample: (6, 12)


def test_recon_workers_accept_what_serial_accepts():
    """Two spawned reconstruction workers and the in-process loop accept
    the same molecules with the same SMILES, in order, and count the same
    failures; the pool is shut down with the pipeline."""
    pg = small_port_model()
    decoded, raw = _decoded_pool(12)
    phore = parse_phore_text(PHORE_TEXT, "p")
    res = {}
    for workers in (0, 2):
        with GenerationPipeline(pg, device="cpu", batch_size=12,
                                recon_workers=workers) as pipe:
            _fixed_pool(pipe, decoded, raw)
            res[workers] = pipe.generate(phore, num_samples=12,
                                         max_batches=1)
            assert (pipe._recon_pool is not None) == (workers > 0)
        assert pipe._recon_pool is None
    assert res[0]["smiles"] == res[2]["smiles"]
    assert res[0]["n_failed"] == res[2]["n_failed"] == 3
    assert len(res[0]["smiles"]) == 9


@pytest.mark.parametrize("bond", [True, False])
def test_save_pool_writes_the_jax_pipelines_files(bond, tmp_path):
    """The same raw pool through the JAX pipeline and the port's: the same
    files, the same npz keys `{pred_node,pred_pos,pred_edge,lig_mask}_<i>`
    with equal arrays (no pred_edge without bond diffusion), the same
    accepted SMILES."""
    _, raw = _decoded_pool(6)
    if not bond:
        raw = dict(raw, pred_edge=None)

    def pool_source(to):
        """Successive batches of the pool (cycling), as `to` arrays."""
        calls = []

        def sample_pool(phore_sample, n, lower, upper):
            idx = (3 * len(calls) + np.arange(n)) % 6
            calls.append(n)
            r = {k: None if v is None else v[idx] for k, v in raw.items()}
            dec = decode_batch(r["pred_node"], r["pred_pos"],
                               r["pred_edge"], r["lig_mask"],
                               include_bond=bond)
            return dec, {k: None if v is None else to(v)
                         for k, v in r.items()}
        return sample_pool

    phore = parse_phore_text(PHORE_TEXT, "p")
    # without a bond head the bonds come from the distances
    add_edge = "predicted" if bond else "distance"
    pipe = GenerationPipeline(small_port_model(bond_diffusion=bond),
                              device="cpu", batch_size=3, add_edge=add_edge)
    pipe.sample_pool = pool_source(torch.from_numpy)
    pipe._count_interval = lambda sample: (6, 12)
    pres = pipe.generate(phore, num_samples=5, out_dir=str(tmp_path / "p"),
                         save_pool=True)

    jcfg = jdefault_config("zinc_300")
    jcfg.model.bond_diffusion = bond
    jpipe = jpipeline.GenerationPipeline.__new__(
        jpipeline.GenerationPipeline)
    jpipe.cfg, jpipe.add_edge, jpipe.batch_size = jcfg, add_edge, 3
    jpipe.keep_traj, jpipe.seed, jpipe.mesh = False, 2024, None
    jpipe._recon_pool = None
    jpipe.prepare_phore = lambda ph: None
    jpipe._count_interval = lambda sample: (6, 12)
    jpipe.sample_pool = pool_source(np.asarray)
    from phoregen_tpu.data.phore import parse_phore_text as jparse
    jres = jpipe.generate(jparse(PHORE_TEXT, "p"), num_samples=5,
                          out_dir=str(tmp_path / "j"), save_pool=True)

    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    assert files(str(tmp_path / "p")) == files(str(tmp_path / "j"))
    assert pres["smiles"] == jres["smiles"]
    name = os.path.join("pipe_phore", "pipe_phore_samples_all.npz")
    got = np.load(str(tmp_path / "p" / name))
    # the JAX pipeline means to drop None entries, but its np.asarray(None)
    # is no longer None and lands as a pickled object array: the port
    # writes no such key (this file was written here a moment ago)
    want = np.load(str(tmp_path / "j" / name), allow_pickle=True)
    jkeys = [k for k in want.files if want[k].dtype != object
             or want[k].item() is not None]
    assert sorted(got.files) == sorted(jkeys)
    assert ("pred_edge_0" in got.files) == bond
    assert len({f.rsplit("_", 1)[1] for f in got.files}) >= 2
    for k in jkeys:
        np.testing.assert_array_equal(got[k], want[k])


def test_out_of_memory_halves_the_batch_and_other_errors_raise():
    """A batch that runs the card out of memory is charged to the budget
    whole and retried at half the size; any other error propagates."""
    pg = small_port_model()
    decoded, raw = _decoded_pool(8)
    phore = parse_phore_text(PHORE_TEXT, "p")
    pipe = GenerationPipeline(pg, device="cpu", batch_size=8)
    _fixed_pool(pipe, decoded, raw)
    fixed, asked = pipe.sample_pool, []

    def sample_pool(phore_sample, n, lower, upper):
        asked.append(n)
        if n > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return fixed(phore_sample, n, lower, upper)
    pipe.sample_pool = sample_pool
    res = pipe.generate(phore, num_samples=8, max_batches=1)
    assert asked == [8, 4, 2]
    assert res["n_sampled"] == 2
    assert res["n_failed"] == 8 + 4 + (2 - res["n_finished"])

    def broken(phore_sample, n, lower, upper):
        raise RuntimeError("not a memory fault")
    pipe.sample_pool = broken
    with pytest.raises(RuntimeError, match="not a memory fault"):
        pipe.generate(phore, num_samples=2)


# -------------------------------------------------------------------- CLI

def test_cli_save_pool_recon_workers_and_chunks(tmp_path, capsys):
    """A CPU run of release/flagship_r4 (two strided steps) with
    `--save_pool --recon_workers 2 --chunk_steps 1` writes what the JAX
    CLI writes for the same options: time_chain.txt, the SMILES list and
    `<name>_samples_all.npz` with the JAX key layout; the startup line
    names the native library. `--sample_devices 2` on the CPU samples the
    pool in two shards (it used to raise), with `--chunk_steps` unsharded
    after a warning; on `cuda`, more devices than are visible is a
    SystemExit that names both numbers."""
    from phoregen_tpu_torch.cli import sample as cli
    phore = os.path.join(ROOT, "tests", "fixtures", "phores",
                         "P03211_merge.phore")
    out_dir = str(tmp_path / "out")
    base = ["--ckpt", os.path.join(ROOT, "release", "flagship_r4"),
            "--phore", phore, "--device", "cpu", "--result_path", out_dir,
            "--num_samples", "2", "--batch_size", "2", "--max_batches", "1",
            "--sample_steps", "2", "--sample_nodes_mode", "normal",
            "--normal_scale", "6.0", "--pos_guidance_opt", json.dumps(
                [{"type": "atom_prox", "min_d": 1.0, "max_d": 3.0},
                 {"type": "center_prox"}])]
    n_cuda = torch.cuda.device_count()
    out = cli.main(base + ["--save_pool", "--recon_workers", "2",
                           "--chunk_steps", "1"])
    assert "host bond perception: native library" in capsys.readouterr().out
    assert out["pipeline"]._recon_pool is None
    res, = out["results"]
    name = parse_phore_file(phore).name
    assert res["name"] == name and res["n_sampled"] == 2
    for f in ("time_chain.txt", os.path.join(name, f"{name}_smiles.txt"),
              os.path.join(name, f"{name}_samples_all.npz")):
        assert os.path.exists(os.path.join(out_dir, f)), f
    sdfs = [f for f in os.listdir(os.path.join(out_dir, name))
            if f.endswith(".sdf")]
    assert len(sdfs) == res["n_finished"]
    pool = np.load(os.path.join(out_dir, name, f"{name}_samples_all.npz"))
    assert sorted(pool.files) == ["lig_mask_0", "pred_edge_0", "pred_node_0",
                                  "pred_pos_0"]
    B, NL = pool["lig_mask_0"].shape
    assert B == 2 and pool["pred_edge_0"].shape == (2, NL, NL, 6)
    sharded = cli.main(base + ["--sample_devices", "2", "--result_path",
                               str(tmp_path / "sharded")])
    assert "Pool-parallel sampling over 2 devices" in \
        capsys.readouterr().out
    assert [d.type for d in sharded["pipeline"].devices] == ["cpu", "cpu"]
    assert sharded["results"][0]["n_sampled"] == 2
    chunked = cli.main(base + ["--sample_devices", "2", "--chunk_steps", "1",
                               "--result_path", str(tmp_path / "chunked")])
    assert "ignored with --chunk_steps" in capsys.readouterr().out
    assert len(chunked["pipeline"].devices) == 1
    with pytest.raises(SystemExit, match=f"asks for {n_cuda + 1} CUDA "
                                         f"devices, but {n_cuda} are"):
        cli.main(base + ["--device", "cuda", "--sample_devices",
                         str(n_cuda + 1)])
    # XLA's --unroll has no counterpart (the help text says why)
    with pytest.raises(SystemExit):
        cli.parse_args(base + ["--unroll", "2"])
