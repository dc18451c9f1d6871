"""Toolkit-free MDL V2000 SDF/MOL reader + `check_mol` loader.

Counterpart of `phoregen_tpu/data/sdf.py` (reference `utils/misc.py:44-56`,
`check_mol`): the loader uses RDKit when present and otherwise a
pure-Python V2000 parser that gives `SimpleMol` records, the record type
the reconstruction pipeline emits, so what `sample/writers.py::write_sdf`
writes reads back with no chemistry toolkit.

Only the V2000 fields this framework produces/consumes are parsed: the
counts line, atom coordinates + element symbols + legacy charge codes, the
bond block (orders 1..4; 4 = aromatic per MDL), and `M  CHG` properties
(which override legacy codes, per the spec).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..sample.chem import HAVE_RDKIT, SimpleMol

# Full symbol table (Z=1..86): real SDF files carry explicit hydrogens and
# occasional exotic elements; vocabulary filtering belongs to featurization
# (`data/mol.py`), not the parser.
_PERIODIC = (
    "H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe "
    "Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In "
    "Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf "
    "Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn").split()
_SYMBOL_TO_Z = {s: z for z, s in enumerate(_PERIODIC, start=1)}

# legacy atom-block charge codes (field 5): 0 none, 1 +3, 2 +2, 3 +1,
# 4 doublet radical (charge 0), 5 -1, 6 -2, 7 -3
_LEGACY_CHARGE = {0: 0, 1: 3, 2: 2, 3: 1, 4: 0, 5: -1, 6: -2, 7: -3}


class SdfParseError(ValueError):
    pass


def parse_molblock(text: str) -> SimpleMol:
    """Parse one V2000 molblock (header + counts + atoms + bonds + props)."""
    lines = text.split("\n")
    if len(lines) < 4:
        raise SdfParseError("molblock too short")
    counts = lines[3]
    if "V3000" in counts:
        raise SdfParseError("V3000 molblocks are not supported "
                            "without RDKit")
    try:
        n_atoms = int(counts[0:3])
        n_bonds = int(counts[3:6])
    except ValueError as e:
        raise SdfParseError(f"bad counts line: {counts!r}") from e
    if len(lines) < 4 + n_atoms + n_bonds:
        raise SdfParseError("truncated molblock")

    elements: List[int] = []
    pos = np.zeros((n_atoms, 3), dtype=np.float64)
    charges = np.zeros(n_atoms, dtype=np.int32)
    for a in range(n_atoms):
        ln = lines[4 + a]
        # fixed columns per spec; fall back to whitespace split for files
        # written with looser formatting
        try:
            xyz = (float(ln[0:10]), float(ln[10:20]), float(ln[20:30]))
            sym = ln[31:34].strip()
            ccode = int(ln[36:39]) if ln[36:39].strip() else 0
        except (ValueError, IndexError):
            parts = ln.split()
            if len(parts) < 4:
                raise SdfParseError(f"bad atom line: {ln!r}")
            xyz = (float(parts[0]), float(parts[1]), float(parts[2]))
            sym = parts[3]
            ccode = int(parts[5]) if len(parts) > 5 else 0
        z = _SYMBOL_TO_Z.get(sym)
        if z is None:
            raise SdfParseError(f"unknown element symbol {sym!r}")
        elements.append(z)
        pos[a] = xyz
        charges[a] = _LEGACY_CHARGE.get(ccode, 0)

    src, dst, order = [], [], []
    for b in range(n_bonds):
        ln = lines[4 + n_atoms + b]
        try:
            i = int(ln[0:3]) - 1
            j = int(ln[3:6]) - 1
            t = int(ln[6:9])
        except (ValueError, IndexError):
            parts = ln.split()
            try:
                i, j, t = (int(parts[0]) - 1, int(parts[1]) - 1,
                           int(parts[2]))
            except (ValueError, IndexError) as e:
                raise SdfParseError(f"bad bond line: {ln!r}") from e
        if not (0 <= i < n_atoms and 0 <= j < n_atoms):
            raise SdfParseError(f"bond index out of range: {ln!r}")
        # directed both ways, matching reconstruction output convention
        src += [i, j]
        dst += [j, i]
        order += [t, t]

    # M  CHG property lines override all legacy codes (MDL spec: presence
    # of any M CHG/RAD resets atom-block charges to 0)
    saw_chg = False
    for ln in lines[4 + n_atoms + n_bonds:]:
        if ln.startswith("M  CHG"):
            if not saw_chg:
                charges[:] = 0
                saw_chg = True
            fields = ln.split()
            n_entries = int(fields[2])
            for k in range(n_entries):
                idx = int(fields[3 + 2 * k]) - 1
                charges[idx] = int(fields[4 + 2 * k])
        elif ln.startswith("M  END"):
            break

    bond_index = (np.array([src, dst], dtype=np.int64) if src
                  else np.zeros((2, 0), dtype=np.int64))
    bond_type = (np.array(order, dtype=np.int64) if order
                 else np.zeros((0,), dtype=np.int64))
    mol = SimpleMol(elements=elements, pos=pos, bond_index=bond_index,
                    bond_type=bond_type)
    mol.charges = charges  # optional attribute; SimpleMol core is unchanged
    return mol


def read_sdf(path: str) -> List[SimpleMol]:
    """All records of an .sdf file ($$$$-separated molblocks)."""
    with open(path) as f:
        lines = f.read().split("\n")
    mols, rec = [], []
    # split on `$$$$` delimiter LINES (not substrings) so an empty name
    # line in the 3-line header survives intact
    for ln in lines + ["$$$$"]:
        if ln.strip() == "$$$$":
            if any(l.strip() for l in rec):
                mols.append(parse_molblock("\n".join(rec)))
            rec = []
        else:
            rec.append(ln)
    return mols


def remove_hydrogens(mol: SimpleMol) -> SimpleMol:
    """Heavy-atom view with bond reindexing (reference `remove_H`,
    `datasets/phoregen.py:186-285` performs the same on RDKit mols before
    featurization). H-H bonds and bonds to H are dropped."""
    keep = [i for i, z in enumerate(mol.elements) if z != 1]
    remap = {old: new for new, old in enumerate(keep)}
    elements = [mol.elements[i] for i in keep]
    pos = mol.pos[keep]
    src, dst, order = [], [], []
    if mol.bond_index is not None:
        for (i, j), t in zip(mol.bond_index.T, mol.bond_type):
            if int(i) in remap and int(j) in remap:
                src.append(remap[int(i)])
                dst.append(remap[int(j)])
                order.append(int(t))
    out = SimpleMol(
        elements=elements, pos=pos,
        bond_index=(np.array([src, dst], dtype=np.int64) if src
                    else np.zeros((2, 0), dtype=np.int64)),
        bond_type=(np.array(order, dtype=np.int64) if order
                   else np.zeros((0,), dtype=np.int64)))
    if getattr(mol, "charges", None) is not None:
        out.charges = mol.charges[keep]
    return out


def check_mol(mol, use_rdkit: Optional[bool] = None):
    """Normalize a molecule argument to a loaded molecule object.

    Parity with reference `utils/misc.py:44-56`: a `.sdf` path loads the
    first record, a `.mol` path loads the molblock, a molecule object
    passes through, anything else raises NotImplementedError. With RDKit
    present (or `use_rdkit=True`) the RDKit loaders are used so downstream
    featurization sees real `Chem.Mol` objects.
    """
    rdkit = HAVE_RDKIT if use_rdkit is None else use_rdkit
    if isinstance(mol, str):
        if not os.path.exists(mol):
            raise NotImplementedError(f"Unsupported objects: `{mol}`")
        ext = os.path.splitext(mol)[1]
        if ext == ".sdf":
            if rdkit:
                from rdkit import Chem  # type: ignore
                return next(iter(Chem.SDMolSupplier(mol)))
            recs = read_sdf(mol)
            if not recs:
                raise SdfParseError(f"no records in {mol}")
            return recs[0]
        if ext == ".mol":
            if rdkit:
                from rdkit import Chem  # type: ignore
                return Chem.MolFromMolFile(mol)
            with open(mol) as f:
                return parse_molblock(f.read())
        raise NotImplementedError(f"Unsupported file: `{mol}`")
    if isinstance(mol, SimpleMol):
        return mol
    if rdkit:
        from rdkit import Chem  # type: ignore
        if isinstance(mol, Chem.Mol):
            return mol
    raise NotImplementedError(f"Unsupported objects: `{mol}`")
