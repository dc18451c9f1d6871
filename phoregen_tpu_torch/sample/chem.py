"""Chemistry backend boundary.

The reference reaches RDKit/OpenBabel for reconstruction and sanitization
(`utils/sample_utils.py`). Those toolkits are optional here: when RDKit is
importable we use it with full repair-loop parity; otherwise a pure-Python
`SimpleMol` backend provides valence-table sanitization, connectivity checks
and canonical-ish formula strings so the full pipeline (including acceptance
criteria) runs hermetically. The backend in use is reported so downstream
metrics are never silently mixed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import ELEMENT_SYMBOLS

try:  # gated import — RDKit is an optional heavy dependency
    from rdkit import Chem as _Chem          # type: ignore
    from rdkit import Geometry as _Geometry  # type: ignore
    HAVE_RDKIT = True
except Exception:  # pragma: no cover - environment without RDKit
    _Chem = None
    _Geometry = None
    HAVE_RDKIT = False

try:
    from openbabel import openbabel as _ob   # type: ignore
    HAVE_OPENBABEL = True
except Exception:  # pragma: no cover
    _ob = None
    HAVE_OPENBABEL = False


class MolReconsError(Exception):
    """Raised when a generated molecule cannot be reconstructed/sanitized."""


# Allowed total valences per element (heavy-atom bonds; charge-neutral),
# following the EDM table (reference `utils/predict_bonds.py:100-103`).
ALLOWED_VALENCES = {
    "H": (1,), "B": (3,), "C": (4,), "N": (3,), "O": (2,), "F": (1,),
    "Si": (4,), "P": (3, 5), "S": (2, 4, 6), "Cl": (1,), "Br": (1,), "I": (1,),
}


@dataclasses.dataclass
class SimpleMol:
    """Minimal molecule record for the RDKit-free backend."""
    elements: List[int]            # atomic numbers
    pos: np.ndarray                # [n, 3]
    bond_index: Optional[np.ndarray]  # [2, E] directed (both ways)
    bond_type: Optional[np.ndarray]   # [E] 1..4 (4 = aromatic)

    def num_atoms(self) -> int:
        return len(self.elements)

    def undirected_bonds(self) -> List[Tuple[int, int, int]]:
        out = []
        if self.bond_index is None:
            return out
        for (i, j), t in zip(self.bond_index.T, self.bond_type):
            if i < j:
                out.append((int(i), int(j), int(t)))
        return out

    def formula(self) -> str:
        counts: Dict[str, int] = {}
        for z in self.elements:
            s = ELEMENT_SYMBOLS.get(int(z), "X")
            counts[s] = counts.get(s, 0) + 1
        parts = []
        for s in sorted(counts, key=lambda s: (s != "C", s)):
            n = counts[s]
            parts.append(s + (str(n) if n > 1 else ""))
        return "".join(parts)


def fragment_count(n: int, bonds: Sequence[Tuple[int, int, int]]) -> int:
    """Number of connected components over n atoms and undirected bonds."""
    if n <= 0:
        return 0
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j, _ in bonds:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
    return len({find(i) for i in range(n)})


def _connected(n: int, bonds: Sequence[Tuple[int, int, int]]) -> bool:
    return fragment_count(n, bonds) <= 1


def sanitize_simple(mol: SimpleMol, allow_h_fill: bool = True) -> bool:
    """Valence-table sanitization for the RDKit-free backend.

    An atom passes if its heavy-bond order sum (aromatic = 1.5) does not
    exceed its maximum allowed valence (implicit hydrogens fill the rest);
    aromatic bonds must come in ring-plausible pairs (every aromatic atom has
    >= 2 aromatic bonds).
    """
    n = mol.num_atoms()
    if n == 0:
        return False
    order_sum = np.zeros(n)
    arom_deg = np.zeros(n, dtype=int)
    for i, j, t in mol.undirected_bonds():
        o = 1.5 if t == 4 else float(t)
        order_sum[i] += o
        order_sum[j] += o
        if t == 4:
            arom_deg[i] += 1
            arom_deg[j] += 1
    for idx, z in enumerate(mol.elements):
        sym = ELEMENT_SYMBOLS.get(int(z))
        if sym is None:
            return False
        max_val = max(ALLOWED_VALENCES[sym])
        # allow the +0.5 aromatic rounding and one unit of charge slack for N
        slack = 0.5 if arom_deg[idx] else 0.0
        if sym == "N":
            slack += 1.0  # N+ repair parity with `fix_valence`
        if order_sum[idx] > max_val + slack + 1e-6:
            return False
        if arom_deg[idx] == 1:
            return False  # dangling aromatic bond cannot be kekulized
    return True


def is_connected(mol: SimpleMol) -> bool:
    return _connected(mol.num_atoms(), mol.undirected_bonds())


def mol_to_smiles(mol) -> Optional[str]:
    """SMILES via RDKit, or a formula pseudo-identifier in fallback mode."""
    if HAVE_RDKIT and not isinstance(mol, SimpleMol):
        try:
            return _Chem.MolToSmiles(mol)
        except Exception:
            return None
    if isinstance(mol, SimpleMol):
        return mol.formula() if is_connected(mol) else mol.formula() + "."
    return None
