"""RDKit molecule featurization (host side, gated on RDKit availability).

Counterpart of `phoregen_tpu/data/mol.py`, gated the same way (`Chem` and
`HAVE_RDKIT` are set when the module is imported, so installing a toolkit
and reloading the module switches it on). Parity target: `parse_mol`
(reference `datasets/phoregen.py:186-285`):
- heavy-atom element classes indexed into the 11-element vocabulary
  (class ids 0..10; the mask class never appears in data);
- conformer positions;
- directed bond list with classes 1..4 (single/double/triple/aromatic);
- hydrogens removed with bond reindexing (`remove_H`).

The optional extra features (hybridization, ring, aromatic, valence)
mirror the reference's config-gated columns. Without RDKit every function
raises `MolParseError`: pairs are built only through RDKit, as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..constants import ATOMIC_NUMBERS

try:
    from rdkit import Chem
    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    Chem = None
    HAVE_RDKIT = False

_CLASS_OF = {z: i for i, z in enumerate(ATOMIC_NUMBERS)}

_BOND_CLASS = {}
if HAVE_RDKIT:
    _BOND_CLASS = {
        Chem.BondType.SINGLE: 1,
        Chem.BondType.DOUBLE: 2,
        Chem.BondType.TRIPLE: 3,
        Chem.BondType.AROMATIC: 4,
    }


class MolParseError(ValueError):
    pass


def load_mol(path: str, sanitize: bool = True):
    """Read one molecule from .sdf/.mol/.mol2 (reference `utils/misc.py`
    check_mol)."""
    if not HAVE_RDKIT:
        raise MolParseError("RDKit not available in this environment")
    if path.endswith(".mol2"):
        mol = Chem.MolFromMol2File(path, sanitize=sanitize)
    elif path.endswith(".sdf"):
        supp = Chem.SDMolSupplier(path, sanitize=sanitize)
        mol = next(iter(supp), None)
    else:
        mol = Chem.MolFromMolFile(path, sanitize=sanitize)
    if mol is None:
        raise MolParseError(f"could not parse {path}")
    return mol


def featurize_mol(mol, remove_h: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray,
                             Optional[np.ndarray], Optional[np.ndarray]]:
    """Mol -> (lig_type [n], lig_pos [n,3], bond_index [2,E], bond_attr [E]).

    Element classes 0..10 over (B C N O F Si P S Cl Br I); directed bonds
    both ways with classes 1..4. Raises MolParseError on out-of-vocabulary
    elements or missing conformer.
    """
    if not HAVE_RDKIT:
        raise MolParseError("RDKit not available in this environment")
    if remove_h:
        mol = Chem.RemoveHs(mol)
    if mol.GetNumConformers() == 0:
        raise MolParseError("molecule has no 3D conformer")
    conf = mol.GetConformer()

    types = []
    for atom in mol.GetAtoms():
        z = atom.GetAtomicNum()
        if z not in _CLASS_OF:
            raise MolParseError(f"element Z={z} outside vocabulary")
        types.append(_CLASS_OF[z])
    lig_type = np.asarray(types, np.int32)
    lig_pos = np.asarray(conf.GetPositions(), np.float32)

    src, dst, attr = [], [], []
    for bond in mol.GetBonds():
        cls = _BOND_CLASS.get(bond.GetBondType())
        if cls is None:
            raise MolParseError(f"bond type {bond.GetBondType()} unsupported")
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        src += [i, j]
        dst += [j, i]
        attr += [cls, cls]
    bond_index = np.asarray([src, dst], np.int64) if src else None
    bond_attr = np.asarray(attr, np.int64) if attr else None
    return lig_type, lig_pos, bond_index, bond_attr


def extra_atom_features(mol, include_hybrid=False, hybrid_one_hot=False,
                        include_valencies=False, include_ring=False,
                        include_aromatic=False) -> Optional[np.ndarray]:
    """Optional per-atom feature columns (reference `datasets/phoregen.py`
    hybridization/valence/ring/aromatic flags); None when all disabled."""
    if not HAVE_RDKIT:
        raise MolParseError("RDKit not available in this environment")
    cols = []
    hyb_order = [Chem.HybridizationType.SP, Chem.HybridizationType.SP2,
                 Chem.HybridizationType.SP3]
    for atom in mol.GetAtoms():
        row = []
        if include_hybrid:
            h = atom.GetHybridization()
            if hybrid_one_hot:
                oh = [1.0 if h == t else 0.0 for t in hyb_order]
                oh.append(1.0 if h not in hyb_order else 0.0)
                row += oh
            else:
                row.append(float(hyb_order.index(h) + 1
                                 if h in hyb_order else 0))
        if include_valencies:
            row.append(float(atom.GetTotalValence()))
        if include_ring:
            row.append(float(atom.IsInRing()))
        if include_aromatic:
            row.append(float(atom.GetIsAromatic()))
        cols.append(row)
    arr = np.asarray(cols, np.float32)
    return arr if arr.size else None
