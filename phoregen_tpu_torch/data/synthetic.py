"""Counterpart of `phoregen_tpu/data/synthetic.py` (numpy, host side).

Synthetic (ligand, pharmacophore) pair generator.

Substitutes for the ZINC/PDBBind datasets in environments without RDKit and
in unit tests: chain-bonded pseudo-molecules with chemically plausible bond
lengths plus pharmacophore points derived from atom positions. Shapes and
vocabularies match the real data layer exactly.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..constants import (NUM_ELEMENT_CLASSES, phore_feat_dim,
                         phore_type_vocab)
from .batching import pad_sample, pick_bucket, collate


# max heavy-atom valence per element class (B C N O F Si P S Cl Br I) —
# mirrors sample/chem.py::ALLOWED_VALENCES maxima so the generated corpus is
# sanitize-valid by construction (a perfect model then has a ~100%
# acceptance ceiling; the old generator placed halogens mid-chain and
# double bonds on oxygens, capping acceptance far below 100%)
_MAX_VALENCE = np.array([3, 4, 3, 2, 1, 4, 5, 6, 1, 1, 1])


def random_molecule(rng: np.random.Generator, n_atoms: int):
    """A random valence-valid chain molecule with ~1.5 A bonds."""
    # 3D self-avoiding-ish random walk
    pos = np.zeros((n_atoms, 3), np.float32)
    for i in range(1, n_atoms):
        step = rng.normal(size=3)
        step = 1.5 * step / np.linalg.norm(step)
        pos[i] = pos[i - 1] + step
    # mostly carbon with some heteroatoms (class ids 0..10); interior atoms
    # (2 chain bonds) must have valence >= 2
    types = rng.choice(NUM_ELEMENT_CLASSES, size=n_atoms,
                       p=_ELEMENT_PROBS).astype(np.int32)
    for i in range(n_atoms):
        interior = 0 < i < n_atoms - 1
        if interior and _MAX_VALENCE[types[i]] < 2:
            types[i] = 1  # halogen mid-chain -> carbon
    # chain bonds (directed both ways); a double bond only where both
    # endpoints have spare valence after their chain degree
    chain_deg = np.full(n_atoms, 2, int)
    chain_deg[0] = chain_deg[-1] = 1 if n_atoms > 1 else 0
    slack = _MAX_VALENCE[types] - chain_deg
    src, dst, attr = [], [], []
    for i in range(1, n_atoms):
        order = 1
        if slack[i - 1] >= 1 and slack[i] >= 1 and rng.random() < 0.25:
            order = 2
            slack[i - 1] -= 1
            slack[i] -= 1
        src += [i - 1, i]
        dst += [i, i - 1]
        attr += [order, order]
    bond_index = np.asarray([src, dst], np.int64) if src else None
    bond_attr = np.asarray(attr, np.int64) if attr else None
    return types, pos, bond_index, bond_attr


_ELEMENT_PROBS = np.array(
    [0.005, 0.70, 0.12, 0.10, 0.02, 0.005, 0.005, 0.02, 0.02, 0.003, 0.002])
_ELEMENT_PROBS = _ELEMENT_PROBS / _ELEMENT_PROBS.sum()


def random_phore(rng: np.random.Generator, lig_pos: np.ndarray,
                 data_name: str = "zinc_300", n_points: Optional[int] = None):
    """Pharmacophore points near random ligand atoms (+ a few EX volumes)."""
    vocab = phore_type_vocab(data_name)
    n_types = len(vocab)
    ex_idx = n_types - 1
    if n_points is None:
        n_points = int(rng.integers(4, 12))
    feats, pos, norms = [], [], []
    for _ in range(n_points):
        anchor = lig_pos[rng.integers(len(lig_pos))]
        p = anchor + rng.normal(scale=0.5, size=3)
        is_ex = rng.random() < 0.25
        tidx = ex_idx if is_ex else int(rng.integers(0, ex_idx))
        onehot = np.zeros(n_types, np.float32)
        onehot[tidx] = 1.0
        alpha = np.float32(rng.uniform(0.5, 1.5))
        has_norm = int(rng.random() < 0.5) if not is_ex else 0
        if has_norm:
            v = rng.normal(size=3)
            v = v / np.linalg.norm(v)
        else:
            v = np.zeros(3)
        # feature layout: [one-hot types, alpha, one_hot(has_norm, 2),
        #                  one_hot(is_EX, 2)] (reference get_phore_data.py:55-68)
        hn = np.zeros(2, np.float32)
        hn[has_norm] = 1.0
        ex = np.zeros(2, np.float32)
        ex[int(is_ex)] = 1.0
        feats.append(np.concatenate([onehot, [alpha], hn, ex]))
        pos.append(p)
        norms.append(v)
    return (np.asarray(feats, np.float32), np.asarray(pos, np.float32),
            np.asarray(norms, np.float32))


def synthetic_raw(rng: np.random.Generator, data_name: str = "zinc_300",
                  n_atoms: Optional[int] = None, max_atoms: int = 30):
    """Unpadded RawSample for the bucketed loader (training-path substitute
    for RDKit-parsed molecules in RDKit-less environments and tests)."""
    from .loader import RawSample
    if n_atoms is None:
        n_atoms = int(rng.integers(8, max_atoms + 1))
    types, lpos, bidx, battr = random_molecule(rng, n_atoms)
    px, ppos, pnorm = random_phore(rng, lpos, data_name)
    center = ppos.mean(axis=0)
    return RawSample(
        lig_type=types, lig_pos=(lpos - center).astype(np.float32),
        bond_index=bidx, bond_attr=battr, phore_x=px,
        phore_pos=(ppos - center).astype(np.float32), phore_norm=pnorm,
        center=center.astype(np.float32), name=f"synthetic_{n_atoms}")


def synthetic_dataset(seed: int, n_samples: int,
                      data_name: str = "zinc_300", max_atoms: int = 30):
    rng = np.random.default_rng(seed)
    return [synthetic_raw(rng, data_name, None, max_atoms)
            for _ in range(n_samples)]


def synthetic_sample(rng: np.random.Generator, data_name: str = "zinc_300",
                     n_atoms: Optional[int] = None, n_lig: int = 32,
                     n_phore: int = 16):
    if n_atoms is None:
        n_atoms = int(rng.integers(8, min(n_lig, 30) + 1))
    types, lpos, bidx, battr = random_molecule(rng, n_atoms)
    px, ppos, pnorm = random_phore(rng, lpos, data_name)
    center = ppos.mean(axis=0)
    lpos = lpos - center
    ppos = ppos - center
    return pad_sample(types, lpos, bidx, battr, px, ppos, pnorm, center,
                      n_lig, n_phore)


def synthetic_batch(seed: int, batch_size: int, data_name: str = "zinc_300",
                    n_lig: int = 32, n_phore: int = 16):
    rng = np.random.default_rng(seed)
    return collate([synthetic_sample(rng, data_name, None, n_lig, n_phore)
                    for _ in range(batch_size)])
