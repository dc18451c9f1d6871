"""Counterpart of `phoregen_tpu/data/transforms.py` (numpy, host side).

Host-side data augmentations (numpy, applied per fetch in the loader).

Parity target: `AddPhoreNoise` (reference `datasets/transform.py:440-480`):
Gaussian position noise (std 0.1) on pharmacophore points plus a random
rotation of each norm vector by up to `angle` degrees about a random axis.
`FeaturizeLigandBond` (reference `datasets/transform.py:483-501`) needs no
transform here: the dense [NL, NL] bond grid *is* the fully-connected directed
edge set (off-diagonal), built directly in `pad_sample`.
"""
from __future__ import annotations

import numpy as np


def _rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about `axis` by `theta` radians."""
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    kx, ky, kz = axis
    K = np.array([[0, -kz, ky], [kz, 0, -kx], [-ky, kx, 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def mask_by_phore(rng: np.random.Generator, lig_pos: np.ndarray,
                  phore_pos: np.ndarray, is_ex: np.ndarray,
                  phore_threshold: float = 1.5,
                  ligand_threshold: float = 1.5,
                  mask_one_phore: bool = False) -> np.ndarray:
    """Context mask for inpainting-style experiments.

    Behavioral equivalent of `MaskByPhore` (reference
    `datasets/transform.py:13-140`, defined but not enabled by
    `get_transform`): pick a spatial group of non-EX phore points (single
    point if `mask_one_phore`), mark ligand atoms within `ligand_threshold`
    of the group as FIXED context (True); the rest (False) are to be
    regenerated. Returns a [n_lig] bool mask.
    """
    non_ex = np.nonzero(~is_ex)[0]
    if len(non_ex) == 0:
        return np.zeros(len(lig_pos), bool)
    seed_idx = int(rng.choice(non_ex))
    group = [seed_idx]
    if not mask_one_phore:
        d = np.linalg.norm(phore_pos[non_ex] - phore_pos[seed_idx], axis=1)
        group = non_ex[d <= phore_threshold].tolist()
    fixed = np.zeros(len(lig_pos), bool)
    for g in group:
        d = np.linalg.norm(lig_pos - phore_pos[g], axis=1)
        fixed |= d <= ligand_threshold
    return fixed


def k_hop_expand(bond_index: np.ndarray, n_atoms: int, seeds: np.ndarray,
                 k_hop: int = 3) -> np.ndarray:
    """Expand a seed atom set k hops along bonds (behavioral equivalent of
    `MaskByPhore_hop`'s hop expansion, reference
    `datasets/transform.py:143-226`). Returns a [n_atoms] bool mask."""
    sel = np.zeros(n_atoms, bool)
    sel[np.asarray(seeds, int)] = True
    if bond_index is None or bond_index.size == 0:
        return sel
    src, dst = bond_index[0], bond_index[1]
    for _ in range(k_hop):
        new = sel.copy()
        new[dst[sel[src]]] = True
        if (new == sel).all():
            break
        sel = new
    return sel


def ligand_phore_affiliation(lig_pos: np.ndarray, phore_pos: np.ndarray,
                             is_ex: np.ndarray, dis_threshold: float = 1.8
                             ) -> np.ndarray:
    """Phore -> nearest-ligand-atom affiliation index (-1 for EX or too far).

    Behavioral equivalent of `AddLigandPhoreEdges`'s phore2ligand mapping
    (reference `datasets/transform.py:316-390`).
    """
    out = -np.ones(len(phore_pos), np.int64)
    if len(lig_pos) == 0:
        return out
    for i, p in enumerate(phore_pos):
        if is_ex[i]:
            continue
        d = np.linalg.norm(lig_pos - p, axis=1)
        j = int(np.argmin(d))
        if d[j] <= dis_threshold:
            out[i] = j
    return out


def add_phore_noise(rng: np.random.Generator, phore_pos: np.ndarray,
                    phore_norm: np.ndarray, noise_std: float = 0.1,
                    angle_deg: float = 5.0):
    """Returns (noisy_pos, rotated_norms); norms stay unit-length, zero norms
    stay zero (no-norm points)."""
    pos = phore_pos + rng.normal(scale=noise_std,
                                 size=phore_pos.shape).astype(np.float32)
    norms = phore_norm.copy()
    has = np.linalg.norm(phore_norm, axis=-1) > 1e-6
    for i in np.where(has)[0]:
        axis = rng.normal(size=3)
        theta = np.deg2rad(rng.uniform(-angle_deg, angle_deg))
        norms[i] = (_rotation_matrix(axis, theta) @ norms[i]).astype(
            np.float32)
    return pos.astype(np.float32), norms
