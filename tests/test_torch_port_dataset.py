"""File-list datasets in the port (`phoregen_tpu_torch/data/dataset.py`)
against the JAX package's: `build_pair_sample`, `PairDataset` and its
per-item cache, `pz_dataset`, and `get_dataset` through zinc_300 file
lists (JSON and pickle) and a pdbbind index, equal field for field.

RDKit is not among the repository's dependencies: the molecule files are
SDFs the port's `write_sdf` wrote (molecules of the `mixed` corpus), read
back with the port's `sdf.read_sdf` into `tests/fake_rdkit.py` molecules,
and each package's `load_mol` is patched to return that molecule, with the
fake toolkit installed so `featurize_mol` runs. Pickles the JAX package
wrote (its cache items, a `pz_dataset` file) are read by the port with the
JAX package blocked from import; a pickle naming any other global is
refused."""
import dataclasses
import importlib
import json
import os
import pickle
import sys

import numpy as np
import pytest

import tests.fake_rdkit as fake
from phoregen_tpu.config import default_config as jdefault_config
from phoregen_tpu.data import dataset as jdataset
from phoregen_tpu.data.loader import RawSample as JRawSample

from phoregen_tpu_torch.config import config_from_dict
from phoregen_tpu_torch.constants import ATOMIC_NUMBERS
from phoregen_tpu_torch.data import dataset as pdataset
from phoregen_tpu_torch.data import sdf as psdf
from phoregen_tpu_torch.data.loader import RawSample
from phoregen_tpu_torch.data.realcorpus import (list_real_phore_files,
                                                mixed_corpus)
from phoregen_tpu_torch.sample.chem import SimpleMol
from phoregen_tpu_torch.sample.writers import write_sdf

FIELDS = [f.name for f in dataclasses.fields(RawSample)]
PKGS = {"jax": "phoregen_tpu", "port": "phoregen_tpu_torch"}
N_MOLS = 6
_BOND = {1: fake.BondType.SINGLE, 2: fake.BondType.DOUBLE,
         3: fake.BondType.TRIPLE, 4: fake.BondType.AROMATIC}


def _same(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert type(a) is RawSample
        for f in FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f
                np.testing.assert_array_equal(x, y, err_msg=f)
            else:
                assert x == y, f


def _fake_from_sdf(path, sanitize=True):
    """The first record of an SDF as a fake RDKit molecule (the port's
    reader does the parsing)."""
    m = psdf.read_sdf(path)[0]
    atoms = [fake.FakeAtom(i, z) for i, z in enumerate(m.elements)]
    bonds = [fake.FakeBond(i, j, _BOND[t]) for i, j, t in
             m.undirected_bonds()]
    return fake.FakeMol(atoms, bonds, pos=m.pos)


@pytest.fixture()
def files(tmp_path):
    """N_MOLS molecule SDFs (the first has 30 heavy atoms or more), one
    real .phore each, and JSON / pickle file lists over them."""
    samples = [s for s in mixed_corpus(3, 40, max_atoms=48)
               if s.bond_index is not None]
    samples.sort(key=lambda s: -s.n_atoms)
    assert samples[0].n_atoms >= 30
    phores = list_real_phore_files()[::97][:N_MOLS]
    pairs = []
    for i, s in enumerate(samples[:N_MOLS]):
        path = str(tmp_path / f"mol_{i}.sdf")
        write_sdf(SimpleMol(elements=[ATOMIC_NUMBERS[t] for t in s.lig_type],
                            pos=s.lig_pos.astype(np.float64) + 3.0,
                            bond_index=s.bond_index, bond_type=s.bond_attr),
                  path, name=f"mol_{i}")
        pairs.append([path, phores[i]])
    lists = {}
    for split, rows in (("train", pairs[:3]), ("valid", pairs[3:5]),
                        ("test", pairs[5:])):
        lists[split + ".json"] = str(tmp_path / f"{split}.json")
        with open(lists[split + ".json"], "w") as f:
            json.dump(rows, f)
        lists[split + ".pkl"] = str(tmp_path / f"{split}.pkl")
        with open(lists[split + ".pkl"], "wb") as f:
            pickle.dump([tuple(r) for r in rows], f)
    lists["index"] = str(tmp_path / "index.pkl")
    with open(lists["index"], "wb") as f:
        pickle.dump({"pdbbind_train": [tuple(r) for r in pairs[:4]],
                     "pdbbind_test": [tuple(r) for r in pairs[4:]]}, f)
    return pairs, lists


@pytest.fixture()
def toolkit(monkeypatch):
    """The fake toolkit installed, both packages' `data/mol.py` reloaded
    against it and their `load_mol` reading SDFs into fake molecules;
    restored after. Yields the monkeypatch."""
    fake.install(monkeypatch)
    for pkg in PKGS.values():
        mod = importlib.reload(importlib.import_module(f"{pkg}.data.mol"))
        monkeypatch.setattr(mod, "load_mol", _fake_from_sdf)
    yield monkeypatch
    monkeypatch.undo()
    for pkg in PKGS.values():
        importlib.reload(importlib.import_module(f"{pkg}.data.mol"))


def _cfgs(save=None, data_name="zinc_300", **ds):
    """(JAX config, port config) alike; `save`: (JAX cache dir, port
    cache dir)."""
    jcfg = jdefault_config(data_name)
    for k, v in ds.items():
        setattr(jcfg.dataset, k, v)
    jcfg.finalize()
    pcfg = config_from_dict(jcfg.to_dict())
    if save:
        jcfg.dataset.save_path, pcfg.dataset.save_path = save
    return jcfg, pcfg


def _block_jax_package(monkeypatch):
    """Make the JAX package unimportable for the rest of the test."""
    for name in list(sys.modules):
        if name == "phoregen_tpu" or name.startswith("phoregen_tpu."):
            monkeypatch.setitem(sys.modules, name, None)


def test_build_pair_sample_equals_jax(toolkit, files):
    pairs, _ = files
    jcfg, pcfg = _cfgs()
    ours = [pdataset.build_pair_sample(m, p, pcfg) for m, p in pairs]
    ref = [jdataset.build_pair_sample(m, p, jcfg) for m, p in pairs]
    _same(ours, ref)
    # centred on the pharmacophore's centre of mass; the molecule's
    # positions are the SDF's (4 decimals) moved by it
    s, (mol_path, _) = ours[0], pairs[0]
    np.testing.assert_allclose(s.phore_pos.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(s.lig_pos + s.center,
                               psdf.read_sdf(mol_path)[0].pos, atol=1e-4)
    assert s.name == "mol_0" and s.bond_index.shape[0] == 2


def test_max_atom_filter_raises_as_jax(toolkit, files):
    pairs, _ = files
    n = len(psdf.read_sdf(pairs[0][0])[0].elements)
    jcfg, pcfg = _cfgs(max_atom=n - 1)
    for mod, cfg in ((pdataset, pcfg), (jdataset, jcfg)):
        with pytest.raises(ValueError, match=f"max_atom {n - 1}"):
            mod.build_pair_sample(*pairs[0], cfg)


def test_pair_dataset_writes_and_reads_its_cache(toolkit, files, tmp_path):
    pairs, _ = files
    cache = str(tmp_path / "cache")
    _, pcfg = _cfgs(save=("", cache))
    built = pdataset.PairDataset(pairs, pcfg).materialize()
    assert sorted(os.listdir(cache)) == [f"mol_{i}.pkl"
                                         for i in range(N_MOLS)]

    def refuse(path, sanitize=True):
        raise AssertionError("the cache is read before any parse")
    pmol = importlib.import_module("phoregen_tpu_torch.data.mol")
    toolkit.setattr(pmol, "load_mol", refuse)
    again = pdataset.PairDataset(pairs, pcfg)
    assert len(again) == N_MOLS
    _same([again[i] for i in range(N_MOLS)], built)


def test_materialize_skips_what_it_cannot_parse(toolkit, files, capsys):
    """A missing molecule file and a molecule over `max_atom` are skipped
    and named, in both packages; the others come through."""
    pairs, _ = files
    n0 = len(psdf.read_sdf(pairs[0][0])[0].elements)
    rest = max(len(psdf.read_sdf(m)[0].elements) for m, _ in pairs[1:])
    assert rest < n0
    bad = pairs + [[pairs[1][0] + ".missing.sdf", pairs[1][1]]]
    jcfg, pcfg = _cfgs(max_atom=n0 - 1)
    ours = pdataset.PairDataset(bad, pcfg).materialize()
    out = capsys.readouterr().out
    ref = jdataset.PairDataset(bad, jcfg).materialize()
    assert len(ours) == N_MOLS - 1
    _same(ours, ref)
    assert out.count("[W] skipping pair") == 2
    assert "max_atom" in out and ".missing.sdf" in out


@pytest.mark.parametrize("kind", ["json", "pkl"])
def test_get_dataset_zinc_file_lists_equal_jax(toolkit, files, tmp_path,
                                               kind):
    _, lists = files
    jcfg, pcfg = _cfgs(
        save=(str(tmp_path / "jcache"), str(tmp_path / "pcache")),
        **{f"zinc_{s}_filelist": lists[f"{s}.{kind}"]
           for s in ("train", "valid", "test")})
    ours = pdataset.get_dataset(pcfg)
    ref = jdataset.get_dataset(jcfg)
    assert [len(x) for x in ours] == [3, 2, 1]
    for a, b in zip(ours, ref):
        _same(a, b)
    # the second pass reads the caches each package wrote
    for a, b in zip(pdataset.get_dataset(pcfg), ref):
        _same(a, b)


def test_get_dataset_pdbbind_index_equals_jax(toolkit, files, tmp_path):
    _, lists = files
    jcfg, pcfg = _cfgs(data_name="pdbbind", pdbbind_filelist=lists["index"])
    ours = pdataset.get_dataset(pcfg)
    assert [len(x) for x in ours] == [4, 0, 2]
    for a, b in zip(ours, jdataset.get_dataset(jcfg)):
        _same(a, b)


def test_cache_written_by_jax_reads_in_the_port(toolkit, files, tmp_path):
    """The JAX package's cache items hold its own `RawSample`; the port
    reads them as its `RawSample` with the JAX package unimportable."""
    pairs, lists = files
    cache = str(tmp_path / "cache")
    jcfg, pcfg = _cfgs(save=(cache, cache),
                       zinc_train_filelist=lists["train.json"])
    ref = jdataset.PairDataset(pairs, jcfg).materialize()
    with open(os.path.join(cache, "mol_0.pkl"), "rb") as f:
        assert b"phoregen_tpu.data.loader" in f.read()
    _block_jax_package(toolkit)
    pmol = importlib.import_module("phoregen_tpu_torch.data.mol")
    toolkit.setattr(pmol, "load_mol", None)     # a parse would fail
    ours = pdataset.PairDataset(pairs, pcfg).materialize()
    _same(ours, ref)
    train, _, _ = pdataset.get_dataset(pcfg)
    _same(train, ref[:3])


def test_pz_dataset_written_by_jax_reads_in_the_port(tmp_path, monkeypatch):
    samples = mixed_corpus(5, 6, max_atoms=48)
    items = [JRawSample(**{f: getattr(s, f) for f in FIELDS})
             for s in samples[:3]]
    items += [{f: getattr(s, f) for f in FIELDS} for s in samples[3:]]
    path = str(tmp_path / "pz.pkl")
    with open(path, "wb") as f:
        pickle.dump(items, f)
    limit = sorted(s.n_atoms for s in samples)[3]
    jcfg, pcfg = _cfgs(max_atom=limit)
    ref = jdataset.pz_dataset(path, jcfg)
    assert 0 < len(ref) < len(samples)
    _block_jax_package(monkeypatch)
    _same(pdataset.pz_dataset(path, pcfg), ref)


class _Act:
    """Pickles as a call of `os.getpid`."""

    def __reduce__(self):
        return (os.getpid, ())


@pytest.mark.parametrize("obj,name", [
    ([_Act()], "getpid"),
    ({"pdbbind_train": [("a", "b")], "x": dataclasses.field},
     "dataclasses.field"),
    (jdataset.PairDataset, "phoregen_tpu.data.dataset.PairDataset"),
])
def test_a_pickle_naming_another_global_is_refused(tmp_path, obj, name):
    path = str(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    with pytest.raises(pickle.UnpicklingError, match=name):
        pdataset.load_pickle(path)
    _, pcfg = _cfgs(zinc_train_filelist=path)
    with pytest.raises(pickle.UnpicklingError, match=name):
        pdataset.get_dataset(pcfg)
