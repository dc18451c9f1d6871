"""Accessible-surface and lipophilicity scoring (AncPhore-style).

Counterpart of `phoregen_tpu/data/surface.py` (reference
`datasets/generate_phorefp.py:259-448`: `calAccSurf`, `labelLipoAtoms`,
`hy_check(follow_ancphore=True)`), host numpy:

- accessible surface fraction by uniform sphere sampling (Fibonacci
  lattice, vectorized numpy);
- per-atom lipophilicity contributions (rule-based, AncPhore-like:
  aliphatic carbons and halogens contribute, atoms adjacent to
  charged/polar centers are suppressed), scaled by exposed surface;
- hydrophobic group detection: rings (<7 atoms) and >=3-H centers whose
  summed lipophilicity exceeds the 9.87 threshold become HY feature points.

The geometry core is toolkit-free; group detection needs RDKit (gated).
"""
from __future__ import annotations

from typing import List

import numpy as np

# van der Waals radii (angstrom) for the supported heavy elements + H
VDW_RADII = {1: 1.2, 5: 1.92, 6: 1.7, 7: 1.55, 8: 1.52, 9: 1.47, 14: 2.1,
             15: 1.8, 16: 1.8, 17: 1.75, 35: 1.85, 53: 1.98}
LIPO_THRESHOLD = 9.87  # AncPhore hydrophobic-group cutoff


def fibonacci_sphere(n: int) -> np.ndarray:
    """n approximately-uniform unit vectors."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(phi)], axis=-1)


def accessible_surface_fraction(pos: np.ndarray, radii: np.ndarray,
                                idx: int, probe: float = 1.4,
                                n_points: int = 252) -> float:
    """Fraction of atom `idx`'s solvent-expanded sphere not buried by
    neighbours (the reference's calAccSurf 'accessible' ratio)."""
    center = pos[idx]
    r = radii[idx] + probe
    pts = center + r * fibonacci_sphere(n_points)          # [P, 3]
    other = np.delete(np.arange(len(pos)), idx)
    if len(other) == 0:
        return 1.0
    d = np.linalg.norm(pts[:, None, :] - pos[None, other, :], axis=-1)
    buried = (d < (radii[other] + probe)[None, :]).any(axis=1)
    return float((~buried).mean())


def atom_radii(elements) -> np.ndarray:
    return np.asarray([VDW_RADII.get(int(z), 1.7) for z in elements],
                      np.float32)


def lipo_contributions(mol) -> np.ndarray:
    """Per-atom lipophilicity scores (RDKit-gated).

    Rules (AncPhore-flavored): sp3/aromatic carbons with no polar neighbour
    and halogens on carbon contribute their exposed-surface-scaled weight;
    atoms bonded to N/O/charged centres contribute 0.
    """
    from rdkit import Chem
    mol = Chem.RemoveHs(mol)
    n = mol.GetNumAtoms()
    pos = np.asarray(mol.GetConformer().GetPositions(), np.float32)
    elements = [a.GetAtomicNum() for a in mol.GetAtoms()]
    radii = atom_radii(elements)
    out = np.zeros(n, np.float32)
    for atom in mol.GetAtoms():
        i = atom.GetIdx()
        z = atom.GetAtomicNum()
        lipophilic = (z == 6) or (z in (9, 17, 35, 53))
        if not lipophilic or atom.GetFormalCharge() != 0:
            continue
        polar_nbr = any(nb.GetAtomicNum() in (7, 8, 15, 16) or
                        nb.GetFormalCharge() != 0
                        for nb in atom.GetNeighbors())
        if polar_nbr:
            continue
        surf = accessible_surface_fraction(pos, radii, i)
        # weight ~ exposed surface area contribution (25 A^2 scale keeps
        # a fully exposed CH3 near the reference's per-atom magnitudes)
        out[i] = surf * 4.0
    return out


def hydrophobic_groups(mol, threshold: float = LIPO_THRESHOLD
                       ) -> List[np.ndarray]:
    """Centroids of hydrophobic groups (HY feature points): small rings and
    methyl-like centers whose lipo sum exceeds `threshold`
    (reference `hy_check(follow_ancphore=True)` semantics)."""
    from rdkit import Chem
    mol = Chem.RemoveHs(mol)
    pos = np.asarray(mol.GetConformer().GetPositions(), np.float32)
    lipo = lipo_contributions(mol)
    centers: List[np.ndarray] = []
    used = set()

    for ring in Chem.GetSSSR(mol):
        ring = list(ring)
        if len(ring) < 7 and lipo[ring].sum() > threshold:
            centers.append(pos[ring].mean(axis=0))
            used.update(ring)

    for atom in mol.GetAtoms():
        i = atom.GetIdx()
        if i in used or atom.GetTotalNumHs() <= 2:
            continue
        group = [i]
        s = lipo[i]
        for nb in atom.GetNeighbors():
            if nb.GetTotalNumHs() >= 1:
                group.append(nb.GetIdx())
                s += lipo[nb.GetIdx()]
        if s > threshold:
            centers.append(pos[group].mean(axis=0))
            used.update(group)
    return centers


# ---------------------------------------------------------------------------
# AncPhore lipophilicity algorithm (full-depth parity)
# ---------------------------------------------------------------------------

def label_lipo_atoms(mol) -> np.ndarray:
    """Per-atom lipophilic 'pcharge' by the AncPhore propagation rules
    (behavioral re-implementation of `labelLipoAtoms`, reference
    `datasets/generate_phorefp.py:372-443`):

    start at 1.0 per atom; H and N/O centres drop to 0 and multiplicatively
    damp their neighbourhoods (0.25 one bond out; H-bearing N / O-H and
    O= neighbourhoods suppressed to 0, carbonyl-adjacent damped 0.6);
    S-H / S= analogous; formally charged centres suppress their whole
    neighbourhood; finally values equal to 0.36 or below 0.25 (except the
    exact 0.15 product) are zeroed."""
    atoms = list(mol.GetAtoms())
    pq = {a.GetIdx(): 1.0 for a in atoms}

    def damp_neighbors(atom, value):
        for b in atom.GetBonds():
            nb = b.GetOtherAtom(atom)
            pq[nb.GetIdx()] = pq[nb.GetIdx()] * value

    for at in atoms:
        z = at.GetAtomicNum()
        idx = at.GetIdx()
        if z == 1:
            pq[idx] = 0.0
        elif z == 7:
            pq[idx] = 0.0
            if not at.GetIsAromatic():
                damp_neighbors(at, 0.25)
                if at.GetTotalNumHs() != 0:
                    for b in at.GetBonds():
                        nb = b.GetOtherAtom(at)
                        pq[nb.GetIdx()] = 0.0
                        damp_neighbors(nb, 0.0)
        elif z == 8:
            pq[idx] = 0.0
            if not at.GetIsAromatic():
                damp_neighbors(at, 0.25)
                for b in at.GetBonds():
                    nb = b.GetOtherAtom(at)
                    if nb.GetAtomicNum() == 1:    # O-H: kill neighbourhood
                        for b1 in at.GetBonds():
                            nnb = b1.GetOtherAtom(at)
                            pq[nnb.GetIdx()] = 0.0
                            damp_neighbors(nnb, 0.0)
                    if b.GetBondType().name == "DOUBLE":  # carbonyl O
                        pq[nb.GetIdx()] = 0.0
                        for b1 in nb.GetBonds():
                            nnb = b1.GetOtherAtom(nb)
                            if nnb.GetIdx() == at.GetIdx():
                                continue
                            pq[nnb.GetIdx()] = 0.0
                            damp_neighbors(nnb, 0.6)
        elif z == 16:
            for b in at.GetBonds():
                nb = b.GetOtherAtom(at)
                if nb.GetAtomicNum() == 1:
                    pq[idx] = 0.0
                    damp_neighbors(at, 0.0)
                if b.GetBondType().name == "DOUBLE":
                    pq[idx] = 0.0
                    damp_neighbors(at, 0.6)
        if at.GetFormalCharge() != 0:
            for b in at.GetBonds():
                nb = b.GetOtherAtom(at)
                pq[nb.GetIdx()] = 0.0
                damp_neighbors(nb, 0.0)

    out = np.zeros(len(atoms), np.float32)
    for at in atoms:
        v = pq[at.GetIdx()]
        # final thresholding (reference :436-439): 0.36 products and
        # sub-0.25 values are noise, except the exact 0.15 chain product
        if abs(v - 0.36) <= 1e-6 or (v < 0.25 and abs(v - 0.15) > 1e-6):
            v = 0.0
        out[at.GetIdx()] = v
    return out


def ancphore_hy_groups(mol, threshold: float = LIPO_THRESHOLD
                       ) -> List[np.ndarray]:
    """Hydrophobic feature points by the full AncPhore recipe (reference
    `hy_check(follow_ancphore=True)`, `generate_phorefp.py:263-302`):
    per-atom pcharge x accessible-VDW-surface AREA (probe 1.4, x4 pi r^2),
    then small rings (<7) and >2-H centres (plus their 1-H neighbours)
    whose summed score exceeds 9.87 become group centroids."""
    from . import phorefp  # gated: phorefp.Chem is the (fake or real) rdkit

    Chem = phorefp.Chem
    mol = Chem.RemoveHs(mol)
    atoms = list(mol.GetAtoms())
    pos = np.asarray(mol.GetConformer().GetPositions(), np.float32)
    elements = [a.GetAtomicNum() for a in atoms]
    radii = atom_radii(elements)
    score = label_lipo_atoms(mol)
    for at in atoms:
        i = at.GetIdx()
        if at.GetAtomicNum() != 1 and score[i] != 0.0:
            frac = accessible_surface_fraction(pos, radii, i, probe=1.4)
            score[i] = frac * 4.0 * np.pi * radii[i] ** 2 * score[i]

    centers: List[np.ndarray] = []
    remaining = set(range(len(atoms)))
    for ring in Chem.GetSSSR(mol):
        ring = list(ring)
        if len(ring) < 7:
            remaining -= set(ring)
            if score[ring].sum() > threshold:
                centers.append(pos[ring].mean(axis=0))

    for i in sorted(remaining):
        at = atoms[i]
        if at.GetTotalNumHs() > 2:
            group = [i]
            s = score[i]
            for b in at.GetBonds():
                nb = b.GetOtherAtom(at)
                if nb.GetTotalNumHs() == 1 and at.GetAtomicNum() != 1:
                    group.append(nb.GetIdx())
                    s += score[nb.GetIdx()]
            if s > threshold:
                centers.append(pos[group].mean(axis=0))
    return centers
