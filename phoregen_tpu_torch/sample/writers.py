"""Molecule/trajectory output writers (pure Python, no toolkit required).

Parity targets: per-mol SDF + SMILES txt + trajectory SDF + timing file
(reference `sample_all.py:154-179`) and the batch SDF/XYZ writers
(reference `models/model_utils.py:293-408`). SDF output is MDL V2000 written
directly; when RDKit is present its writer is used for exactness.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..constants import ELEMENT_SYMBOLS
from .chem import HAVE_RDKIT, SimpleMol

if HAVE_RDKIT:
    from rdkit import Chem  # type: ignore


def sdf_block(elements: Sequence[int], pos: np.ndarray,
              bonds: Sequence[tuple], name: str = "") -> str:
    """One MDL V2000 molblock. bonds: (i, j, order) 0-indexed, order 1..4
    (4 = aromatic per MDL spec)."""
    lines = [name, "  PhoreGenTPU", ""]
    lines.append(f"{len(elements):3d}{len(bonds):3d}  0  0  0  0  0  0  0  0999 V2000")
    for z, p in zip(elements, pos):
        sym = ELEMENT_SYMBOLS.get(int(z), "C")
        lines.append(f"{p[0]:10.4f}{p[1]:10.4f}{p[2]:10.4f} {sym:<3} 0  0  0  0  0  0  0  0  0  0  0  0")
    for i, j, t in bonds:
        lines.append(f"{i + 1:3d}{j + 1:3d}{t:3d}  0  0  0  0")
    lines.append("M  END")
    return "\n".join(lines) + "\n"


def write_sdf(mol, path: str, name: str = "") -> None:
    """Write one molecule (RDKit Mol or SimpleMol) as .sdf."""
    if HAVE_RDKIT and not isinstance(mol, SimpleMol):
        writer = Chem.SDWriter(path)
        writer.write(mol)
        writer.close()
        return
    block = sdf_block(mol.elements, mol.pos, mol.undirected_bonds(), name)
    with open(path, "w") as f:
        f.write(block + "$$$$\n")


def append_sdf(mol, f, name: str = "") -> None:
    if HAVE_RDKIT and not isinstance(mol, SimpleMol):
        f.write(Chem.MolToMolBlock(mol) + "$$$$\n")
        return
    f.write(sdf_block(mol.elements, mol.pos, mol.undirected_bonds(), name)
            + "$$$$\n")


def write_xyz(elements: Sequence[int], pos: np.ndarray, path: str,
              comment: str = "") -> None:
    with open(path, "w") as f:
        f.write(f"{len(elements)}\n{comment}\n")
        for z, p in zip(elements, pos):
            sym = ELEMENT_SYMBOLS.get(int(z), "C")
            # reference emits %.9f (`models/model_utils.py:297-299`)
            f.write(f"{sym} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n")


def write_smiles(smiles_list: List[str], path: str) -> None:
    with open(path, "w") as f:
        for s in smiles_list:
            f.write(s + "\n")


def append_timing(path: str, name: str, n_finished: int, seconds: float
                  ) -> None:
    """Per-phore timing rows — the reference appends `str((name,
    n_finished, seconds))` tuples (reference `sample_all.py:176-179`)."""
    with open(path, "a") as f:
        f.write(str((name, n_finished, seconds)) + "\n")
