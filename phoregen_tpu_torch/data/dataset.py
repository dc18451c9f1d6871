"""Dataset factory: file-list (mol, phore) pairs with a per-item cache, and
the hermetic corpora.

Counterpart of `phoregen_tpu/data/dataset.py` (reference `get_dataset` +
`mol_dataset`, `utils/training_utils.py:106-160`,
`datasets/phoregen.py:155-417`):
- zinc_300: three file lists (train/valid/test), each row one (mol, phore)
  pair; pdbbind: one index pickle with `pdbbind_{train,valid,test}` keys;
- per-item pickle cache keyed by name in `dataset.save_path`, read before
  anything is parsed, so a cache featurized on a host with RDKit trains
  where there is none;
- molecules over `max_atom` heavy atoms are filtered out;
- otherwise the corpora the repository generates from a seed: `mixed`
  (`realcorpus.py`) or `chains` (`synthetic.py`).

File-list format: a pickle or JSON list of [mol_path, phore_path] pairs.
Every pickle here (file lists, the pdbbind index, cache items,
`pz_dataset` files) is read through `_DatasetUnpickler`, which admits
builtins, numpy's array reconstruction and `RawSample` under the JAX
package's or the port's module path (both load as the port's class), and
refuses any other global, naming it.
"""
from __future__ import annotations

import builtins
import json
import os
import pickle
from typing import List, Sequence, Tuple

import numpy as np

from .loader import RawSample
from .phore import featurize_phore, parse_phore_file
from .synthetic import synthetic_dataset

_RAW_SAMPLE_PATHS = frozenset({
    ("phoregen_tpu.data.loader", "RawSample"),
    ("phoregen_tpu_torch.data.loader", "RawSample")})
# builtins a dataset pickle is made of; no callable that acts
_BUILTINS = frozenset({
    "bool", "bytearray", "bytes", "complex", "dict", "float", "frozenset",
    "int", "list", "object", "set", "slice", "str", "tuple"})
# numpy's array and scalar reconstruction, and the helpers pickle
# protocols 0 to 2 name for plain objects and bytes
_ALLOWED = {
    "copyreg": frozenset({"_reconstructor"}),
    "copy_reg": frozenset({"_reconstructor"}),
    "_codecs": frozenset({"encode"}),
    "numpy": frozenset({"dtype", "ndarray"}),
    "numpy.core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "numpy._core.multiarray": frozenset({"_reconstruct", "scalar"}),
    "numpy.core.numeric": frozenset({"_frombuffer"}),
    "numpy._core.numeric": frozenset({"_frombuffer"}),
}


class _DatasetUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _RAW_SAMPLE_PATHS:
            return RawSample
        if module in ("builtins", "__builtin__") and name in _BUILTINS:
            return getattr(builtins, name)
        if name in _ALLOWED.get(module, ()):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"dataset pickle names the global {module}.{name}, which a "
            "dataset file may not hold")


def load_pickle(path: str):
    """A dataset pickle through the restricted unpickler."""
    with open(path, "rb") as f:
        return _DatasetUnpickler(f).load()


def _load_pairs(filelist: str) -> List[Tuple[str, str]]:
    if filelist.endswith(".json"):
        with open(filelist) as f:
            return [tuple(x) for x in json.load(f)]
    return [tuple(x) for x in load_pickle(filelist)]


def build_pair_sample(mol_path: str, phore_path: str, cfg) -> RawSample:
    """Parse + featurize one (mol, phore) pair; centered on the phore COM
    (reference `datasets/phoregen.py:342-353`)."""
    from .mol import featurize_mol, load_mol

    ds = cfg.dataset
    mol = load_mol(mol_path)
    lig_type, lig_pos, bidx, battr = featurize_mol(mol,
                                                   remove_h=ds.remove_H)
    if len(lig_type) > ds.max_atom:
        raise ValueError(f"{mol_path}: {len(lig_type)} atoms > "
                         f"max_atom {ds.max_atom}")
    phore = parse_phore_file(phore_path)
    px, ppos, pnorm, center = featurize_phore(phore, ds.data_name,
                                              norm_mode="new")
    return RawSample(
        lig_type=lig_type, lig_pos=(lig_pos - center).astype(np.float32),
        bond_index=bidx, bond_attr=battr, phore_x=px,
        phore_pos=(ppos - center).astype(np.float32), phore_norm=pnorm,
        center=center,
        name=os.path.splitext(os.path.basename(mol_path))[0])


class PairDataset:
    """Lazy, per-item-cached list of RawSamples from a file list."""

    def __init__(self, pairs: Sequence[Tuple[str, str]], cfg):
        self.pairs = list(pairs)
        self.cfg = cfg
        self.cache_dir = cfg.dataset.save_path or ""
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i: int) -> RawSample:
        mol_path, phore_path = self.pairs[i]
        key = os.path.splitext(os.path.basename(mol_path))[0]
        cache = os.path.join(self.cache_dir, key + ".pkl") \
            if self.cache_dir else ""
        if cache and os.path.exists(cache):
            return load_pickle(cache)
        sample = build_pair_sample(mol_path, phore_path, self.cfg)
        if cache:
            with open(cache, "wb") as f:
                pickle.dump(sample, f)
        return sample

    def materialize(self) -> List[RawSample]:
        out = []
        for i in range(len(self)):
            try:
                out.append(self[i])
            except Exception as e:  # skip unparseable items, like the
                print(f"[W] skipping pair {self.pairs[i]}: {e}")  # reference
        return out


def pz_dataset(dataset_file: str, cfg) -> List[RawSample]:
    """Legacy pre-built-graph path (reference `datasets/phoregen.py:24-152`
    `pz_dataset`): a single pickle holding a list of ready RawSamples (or
    dicts with RawSample fields), filtered by `max_atom`."""
    out = []
    for it in load_pickle(dataset_file):
        s = it if isinstance(it, RawSample) else RawSample(**it)
        if s.n_atoms <= cfg.dataset.max_atom:
            out.append(s)
    return out


def get_dataset(cfg, synthetic_size: int = 0
                ) -> Tuple[List[RawSample], List[RawSample],
                           List[RawSample]]:
    """(train, valid, test) RawSample lists."""
    ds = cfg.dataset
    syn_max = min(ds.max_atom, max(ds.ligand_buckets))

    def _hermetic(seed: int, n: int):
        if ds.corpus == "mixed":
            from .realcorpus import mixed_corpus
            return mixed_corpus(seed, n, ds.data_name,
                                max_phore=ds.max_phore, max_atoms=syn_max,
                                real_frac=ds.real_frac)
        return synthetic_dataset(seed, n, ds.data_name, max_atoms=syn_max)

    if synthetic_size:
        n = synthetic_size
        return (_hermetic(0, n), _hermetic(1, max(n // 10, 8)),
                _hermetic(2, max(n // 10, 8)))

    if ds.data_name == "zinc_300" and ds.zinc_train_filelist:
        return tuple(PairDataset(_load_pairs(fl), cfg).materialize()
                     if fl else [] for fl in (ds.zinc_train_filelist,
                                              ds.zinc_valid_filelist,
                                              ds.zinc_test_filelist))

    if ds.data_name == "pdbbind" and ds.pdbbind_filelist:
        index = load_pickle(ds.pdbbind_filelist)
        return tuple(PairDataset(index.get(f"pdbbind_{split}", []),
                                 cfg).materialize()
                     for split in ("train", "valid", "test"))

    # fallback: hermetic corpus (RDKit-less environments, smoke tests)
    print("[W] no dataset filelists configured; using hermetic "
          f"'{ds.corpus}' pairs")
    return (_hermetic(0, 256), _hermetic(1, 32), _hermetic(2, 32))
