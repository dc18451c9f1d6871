"""LigPhore pair synthesis: ligand -> pharmacophore model (RDKit-gated).

Counterpart of `phoregen_tpu/data/ligphore.py`; every draw comes from the
caller's `np.random.Generator` in the JAX package's order, so one seed
gives one pharmacophore in both packages. Behavioral targets:
- random sub-pharmacophore extraction of 4-8 features
  (reference `utils/phore_utils.py:427-452` `extract_random_phore_from_origin`);
- exclusion-volume synthesis on shells around feature points with
  ligand-clash and mutual-clash filtering
  (reference `utils/phore_utils.py:222-295,455-536`
  `extend_exclusion_volumes` / `generate_ex_by_shell` / `exclude_clashed_ex`);
- feature construction from the per-atom SMARTS fingerprint
  (`phorefp.py`), with aromatic rings collapsed to centroid features
  carrying the ring-plane normal.

This builds (ligand, pharmacophore) pairs from plain ligand SDFs, in place
of the external AncPhore tool's output for pretraining-style data.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .phore import Phore, PhoreFeature
from .phorefp import HAVE_RDKIT, generate_ligand_phore_feat
from ..constants import PHORETYPES_13

# default alpha (tolerance radius) per feature, loosely following the
# conventions visible in shipped .phore files
DEFAULT_ALPHA = {"AR": 1.0, "HY": 1.0, "EX": 0.837}
FALLBACK_ALPHA = 0.7


def _ring_normal(pos: np.ndarray) -> np.ndarray:
    c = pos.mean(axis=0)
    x = pos - c
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    n = vt[-1]
    return n / (np.linalg.norm(n) + 1e-12)


def ligand_features(mol) -> List[PhoreFeature]:
    """All candidate pharmacophore features for a ligand."""
    if not HAVE_RDKIT:
        raise ImportError("RDKit required for LigPhore synthesis")
    from rdkit import Chem
    mol = Chem.RemoveHs(mol)
    fp = generate_ligand_phore_feat(mol, remove_hs=False)
    pos = np.asarray(mol.GetConformer().GetPositions(), np.float32)
    col = {t: i for i, t in enumerate(PHORETYPES_13)}
    feats: List[PhoreFeature] = []

    # aromatic rings -> centroid + plane normal
    ri = mol.GetRingInfo()
    for ring in ri.AtomRings():
        if all(mol.GetAtomWithIdx(i).GetIsAromatic() for i in ring):
            rp = pos[list(ring)]
            c = rp.mean(axis=0)
            n = _ring_normal(rp)
            feats.append(PhoreFeature(
                type="AR", alpha=DEFAULT_ALPHA["AR"], weight=1.0, factor=1.0,
                pos=tuple(c), has_norm=True, norm=tuple(n), label="0",
                anchor_weight=1.0))

    # atom-level features (skip AR: handled above; EX never atom-derived)
    centroid = pos.mean(axis=0)
    for t in PHORETYPES_13:
        if t in ("AR", "EX"):
            continue
        atoms = np.nonzero(fp[:, col[t]])[0]
        for a in atoms:
            p = pos[a]
            has_norm = t in ("HD", "HA", "XB")
            if has_norm:
                # point away from the heavy-neighbor centroid (approximate
                # H / lone-pair direction)
                nbrs = [n.GetIdx() for n in
                        mol.GetAtomWithIdx(int(a)).GetNeighbors()]
                ref = pos[nbrs].mean(axis=0) if nbrs else centroid
                d = p - ref
                d = d / (np.linalg.norm(d) + 1e-12)
            else:
                d = np.zeros(3)
            label = t[2] if t.startswith("CV") and len(t) == 3 else "0"
            feats.append(PhoreFeature(
                type="CV" if t.startswith("CV") else t,
                alpha=DEFAULT_ALPHA.get(t, FALLBACK_ALPHA), weight=1.0,
                factor=1.0, pos=tuple(p), has_norm=bool(has_norm),
                norm=tuple(d), label=label, anchor_weight=1.0))
    return feats


def extract_random_subphore(feats: List[PhoreFeature],
                            rng: np.random.Generator, low_num: int = 4,
                            up_num: int = 8) -> List[PhoreFeature]:
    """Random 4-8 feature subset, deduplicated by position (reference
    `extract_random_phore_from_origin` semantics)."""
    non_ex = [f for f in feats if f.type != "EX"]
    if not non_ex:
        return []
    k = int(rng.integers(low_num, up_num + 1))
    k = min(k, len(non_ex))
    idx = rng.choice(len(non_ex), size=k, replace=False)
    chosen, seen = [], set()
    for i in idx:
        key = tuple(np.round(non_ex[i].pos, 3))
        if key in seen:
            continue
        seen.add(key)
        chosen.append(non_ex[i])
    return chosen


def generate_ex_shell(feats: List[PhoreFeature], lig_pos: np.ndarray,
                      rng: np.random.Generator, low: float = 3.0,
                      up: float = 5.0, num_ex: int = 5,
                      clash_d: float = 2.0, rounds: int = 100
                      ) -> List[PhoreFeature]:
    """Sample EX volumes on shells [low, up] around feature points, rejecting
    points that clash with ligand atoms or other EX (reference
    `generate_ex_by_shell` + `exclude_clashed_ex` behavior)."""
    centers = np.asarray([f.pos for f in feats if f.type != "EX"],
                         np.float32)
    if centers.size == 0:
        return []
    out: List[PhoreFeature] = []
    ex_pos: List[np.ndarray] = []
    for _ in range(rounds):
        if len(out) >= num_ex:
            break
        c = centers[rng.integers(len(centers))]
        v = rng.normal(size=3)
        v /= np.linalg.norm(v) + 1e-12
        r = rng.uniform(low, up)
        p = c + r * v
        if np.min(np.linalg.norm(lig_pos - p, axis=1)) < clash_d:
            continue
        if ex_pos and np.min(np.linalg.norm(
                np.asarray(ex_pos) - p, axis=1)) < clash_d:
            continue
        ex_pos.append(p)
        out.append(PhoreFeature(
            type="EX", alpha=DEFAULT_ALPHA["EX"], weight=0.5, factor=1.0,
            pos=tuple(p), has_norm=False, norm=(0.0, 0.0, 0.0), label="0",
            anchor_weight=1.0))
    return out


def ligand_to_phore(mol, rng: np.random.Generator, name: str = "",
                    low_num: int = 4, up_num: int = 8,
                    num_ex: int = 5) -> Phore:
    """Full LigPhore-style synthesis: fingerprint -> subsample -> EX shell."""
    feats = ligand_features(mol)
    sub = extract_random_subphore(feats, rng, low_num, up_num)
    lig_pos = np.asarray(mol.GetConformer().GetPositions(), np.float32)
    sub = sub + generate_ex_shell(sub, lig_pos, rng, num_ex=num_ex)
    return Phore(name=name or "ligphore", features=sub)
