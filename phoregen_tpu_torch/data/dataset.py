"""Dataset factory: the hermetic corpora.

Counterpart of `phoregen_tpu/data/dataset.py::get_dataset`. The port
trains on the corpora the repository generates from a seed: the `mixed`
corpus (`realcorpus.py`, half of it anchored to the bundled real
pharmacophores) or the `chains` corpus (`synthetic.py`). Training from
ZINC / PDBBind file lists (`PairDataset`, molecule and SDF parsing) is not
ported yet and raises.
"""
from __future__ import annotations

from typing import List, Tuple

from .loader import RawSample
from .synthetic import synthetic_dataset


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
    if (ds.data_name == "zinc_300" and ds.zinc_train_filelist) or (
            ds.data_name == "pdbbind" and ds.pdbbind_filelist):
        raise NotImplementedError(
            "training from ZINC / PDBBind file lists (PairDataset, mol.py, "
            "sdf.py, ligphore.py) is not ported yet: ROADMAP.md, 'Still to "
            "port', file-list datasets. Unset the file lists to train on "
            "the hermetic corpus, or pass --synthetic_size.")
    print("[W] no dataset filelists configured; using hermetic "
          f"'{ds.corpus}' pairs")
    return (_hermetic(0, 256), _hermetic(1, 32), _hermetic(2, 32))
