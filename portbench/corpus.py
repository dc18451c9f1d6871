"""The training traffic's corpus: a frozen copy of the program's hermetic
`mixed` corpus generator (`phoregen_tpu_torch/data/realcorpus.py`, with
`generate_ex_shell` of `data/ligphore.py` and the `RawSample` record of
`data/loader.py`), so that the yardstick does not move with the program.
Numpy only; the same samples from the same seed.

Half of the pairs are anchored to the real pharmacophores bundled under
`data/real_phores/` and `data/phores_for_sampling/`, with a valence-valid
ligand grown onto the typed feature points; the rest are free-grown
molecules whose pharmacophore is derived from the molecule.
"""
from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .reference.constants import MAX_ATOMS, MIN_ATOMS
from .reference.phore import (Phore, PhoreFeature, featurize_phore,
                              parse_phore_file)
from .reference.sampling import cap_phore

# the checkout's root: the bundled phores are read where the run starts
REPO_ROOT = "."
REAL_PHORE_ROOT = os.path.join(REPO_ROOT, "data", "real_phores")
SAMPLING_PHORE_ROOT = os.path.join(REPO_ROOT, "data", "phores_for_sampling")

DEFAULT_ALPHA = {"AR": 1.0, "HY": 1.0, "EX": 0.837}
FALLBACK_ALPHA = 0.7


@dataclasses.dataclass
class RawSample:
    """One unpadded (ligand, pharmacophore) pair in the centered frame."""
    lig_type: np.ndarray    # [n] int
    lig_pos: np.ndarray     # [n, 3] f32
    bond_index: Optional[np.ndarray]  # [2, E] directed
    bond_attr: Optional[np.ndarray]   # [E] int
    phore_x: np.ndarray     # [p, FP] f32
    phore_pos: np.ndarray   # [p, 3] f32
    phore_norm: np.ndarray  # [p, 3] f32
    center: np.ndarray      # [3] f32 original phore COM
    name: str = ""

    @property
    def n_atoms(self) -> int:
        return len(self.lig_type)


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

# element class ids (constants.ATOMIC_NUMBERS order: B C N O F Si P S Cl Br I)
_B, _C, _N, _O, _F, _SI, _P, _S, _CL, _BR, _I = range(11)
# strict neutral-molecule valence caps (no charge slack — the corpus must
# sanitize without the N+ repair path)
_MAX_VAL = np.array([3, 4, 3, 2, 1, 4, 5, 6, 1, 1, 1], np.float64)

_BOND_LEN = 1.5
_AROM_RING_R = 1.39


def zinc_like_size(rng: np.random.Generator, max_atoms: int = MAX_ATOMS,
                   mean: float = 23.0, std: float = 6.0,
                   lo: int = 15) -> int:
    """Drug-like heavy-atom count: truncated normal matching the ZINC
    distribution the reference trains on (reference molecules span 4-78
    heavy atoms with a ~23-atom mode, `models/diffusion.py:30-31`,
    `datasets/phoregen.py:37`). Round-3 pools averaged 9-15 atoms because
    the corpus grower targeted `anchors + U(2,14)` — validity at 9 atoms
    is not the game the reference plays (VERDICT round 3, item 4)."""
    n = int(round(rng.normal(mean, std)))
    # upper clip: ZINC-like corpora cap near 40; complex-scale fine-tune
    # corpora (higher mean) run to the model bound
    hi = min(max_atoms, 40 if mean <= 30 else MAX_ATOMS)
    return int(np.clip(n, min(lo, hi), hi))


def list_real_phore_files(include_sampling: bool = True) -> List[str]:
    """All bundled real `.phore` files, deterministic order."""
    files = sorted(glob.glob(os.path.join(REAL_PHORE_ROOT, "*", "*.phore")))
    if include_sampling:
        files += sorted(glob.glob(
            os.path.join(SAMPLING_PHORE_ROOT, "*.phore")))
    return files


# --------------------------------------------------------------------------
# valence-tracked molecule builder
# --------------------------------------------------------------------------

class MolBuilder:
    """Grows a molecule atom-by-atom with hard valence/connectivity
    guarantees (aromatic bond order counts 1.5; aromatic atoms get the +0.5
    kekulization slack that `sanitize_simple` grants)."""

    def __init__(self, rng: np.random.Generator, max_atoms: int = MAX_ATOMS):
        self.rng = rng
        self.max_atoms = max_atoms
        self.types: List[int] = []
        self.pos: List[np.ndarray] = []
        self.bonds: Dict[Tuple[int, int], int] = {}
        self.order_sum: List[float] = []
        self.arom_deg: List[int] = []
        self.pinned: List[bool] = []          # anchor atoms stay on-feature
        self.arom_rings: List[Tuple[int, ...]] = []

    @property
    def n(self) -> int:
        return len(self.types)

    def slack(self, i: int) -> float:
        bonus = 0.5 if self.arom_deg[i] else 0.0
        return _MAX_VAL[self.types[i]] + bonus - self.order_sum[i]

    def add_atom(self, cls: int, p: np.ndarray,
                 pinned: bool = False) -> Optional[int]:
        if self.n >= self.max_atoms:
            return None
        self.types.append(int(cls))
        self.pos.append(np.asarray(p, np.float64))
        self.order_sum.append(0.0)
        self.arom_deg.append(0)
        self.pinned.append(pinned)
        return self.n - 1

    def add_bond(self, i: int, j: int, order: int = 1) -> bool:
        if i == j:
            return False
        key = (min(i, j), max(i, j))
        if key in self.bonds:
            return False
        o = 1.5 if order == 4 else float(order)
        if self.slack(i) < o - 1e-9 or self.slack(j) < o - 1e-9:
            return False
        self.bonds[key] = order
        self.order_sum[i] += o
        self.order_sum[j] += o
        if order == 4:
            self.arom_deg[i] += 1
            self.arom_deg[j] += 1
        return True

    def upgrade_bond(self, i: int, j: int, new_order: int) -> bool:
        key = (min(i, j), max(i, j))
        old = self.bonds.get(key)
        if old is None or old == 4 or new_order <= old:
            return False
        delta = float(new_order - old)
        if self.slack(i) < delta - 1e-9 or self.slack(j) < delta - 1e-9:
            return False
        self.bonds[key] = new_order
        self.order_sum[i] += delta
        self.order_sum[j] += delta
        return True

    # ----- group builders -----

    def add_aromatic_ring(self, center: np.ndarray,
                          normal: Optional[np.ndarray] = None
                          ) -> Optional[int]:
        """Regular aromatic six-ring at `center`; returns one ring atom
        (the attachment point) or None if out of budget."""
        if self.n + 6 > self.max_atoms:
            return None
        if normal is None or not np.any(normal):
            normal = self.rng.normal(size=3)
        normal = normal / (np.linalg.norm(normal) + 1e-12)
        u = np.cross(normal, [1.0, 0.0, 0.0])
        if np.linalg.norm(u) < 1e-6:
            u = np.cross(normal, [0.0, 1.0, 0.0])
        u /= np.linalg.norm(u)
        v = np.cross(normal, u)
        phase = self.rng.uniform(0, 2 * np.pi)
        # at most one ring nitrogen (pyridine-like); order_sum 3.0 <= 3+0.5
        n_slot = int(self.rng.integers(0, 6)) \
            if self.rng.random() < 0.3 else -1
        idx = []
        for k in range(6):
            ang = phase + k * np.pi / 3
            p = center + _AROM_RING_R * (np.cos(ang) * u + np.sin(ang) * v)
            cls = _N if k == n_slot else _C
            idx.append(self.add_atom(cls, p, pinned=True))
        for k in range(6):
            self.add_bond(idx[k], idx[(k + 1) % 6], order=4)
        self.arom_rings.append(tuple(idx))
        # attachment: a carbon ring atom (aromatic C keeps 1.0 slack)
        carbons = [i for i in idx if self.types[i] == _C]
        return carbons[int(self.rng.integers(len(carbons)))]

    def add_plain_ring(self, attach: int, size: int = 6) -> bool:
        """Pendant aliphatic ring bonded to `attach` (single bonds)."""
        if self.n + size > self.max_atoms or self.slack(attach) < 1:
            return False
        base = np.asarray(self.pos[attach])
        d = self.rng.normal(size=3)
        d /= np.linalg.norm(d) + 1e-12
        center = base + (_BOND_LEN + 1.2) * d
        u = np.cross(d, self.rng.normal(size=3))
        u /= np.linalg.norm(u) + 1e-12
        v = np.cross(d, u)
        r = 1.54 / (2 * np.sin(np.pi / size))
        idx = []
        for k in range(size):
            ang = 2 * np.pi * k / size
            p = center + r * (np.cos(ang) * u + np.sin(ang) * v)
            idx.append(self.add_atom(_C, p))
        for k in range(size):
            self.add_bond(idx[k], idx[(k + 1) % size], order=1)
        return self.add_bond(attach, idx[0], order=1)

    def _component(self, a: int) -> List[int]:
        """Atoms bonded-reachable from a."""
        adj: Dict[int, List[int]] = {}
        for (i, j) in self.bonds:
            adj.setdefault(i, []).append(j)
            adj.setdefault(j, []).append(i)
        seen = {a}
        stack = [a]
        while stack:
            x = stack.pop()
            for y in adj.get(x, ()):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return list(seen)

    def _routable(self, a: int, toward: np.ndarray) -> Optional[int]:
        """`a` itself if it can take one more bond, else the closest atom to
        `toward` in a's component that can — keeps anchored groups connected
        even when the natural attachment atom is valence-saturated."""
        if self.slack(a) >= 1:
            return a
        cand = [i for i in self._component(a) if self.slack(i) >= 1]
        if not cand:
            return None
        d = [np.linalg.norm(np.asarray(self.pos[i]) - toward) for i in cand]
        return cand[int(np.argmin(d))]

    def connect_chain(self, a: int, b: int) -> None:
        """Connect atoms a—b with a zig-zag carbon chain (step ~1.5 A)."""
        ra = self._routable(a, np.asarray(self.pos[b]))
        rb = self._routable(b, np.asarray(self.pos[a]))
        if ra is None or rb is None:
            return
        a, b = ra, rb
        pa, pb = np.asarray(self.pos[a]), np.asarray(self.pos[b])
        dist = float(np.linalg.norm(pb - pa))
        n_steps = max(1, int(round(dist / _BOND_LEN)))
        if n_steps == 1:
            self.add_bond(a, b, order=1)
            return
        d = (pb - pa) / dist
        u = np.cross(d, self.rng.normal(size=3))
        u /= np.linalg.norm(u) + 1e-12
        prev = a
        for k in range(1, n_steps):
            p = pa + d * (dist * k / n_steps) + u * (0.4 * (k % 2))
            nxt = self.add_atom(_C, p)
            if nxt is None:          # atom budget exhausted mid-chain:
                self.add_bond(prev, b, order=1)  # close directly (stretched
                return                           # bond beats a fragment)
            self.add_bond(prev, nxt, order=1)
            prev = nxt
        self.add_bond(prev, b, order=1)

    # ----- decoration -----

    _DECOR_CLASSES = np.array([_C, _N, _O, _F, _S, _CL])
    _DECOR_PROBS = np.array([0.62, 0.12, 0.12, 0.05, 0.04, 0.05])

    def decorate(self, target_atoms: int) -> None:
        """Random short branches / pendant rings until `target_atoms`."""
        tries = 0
        while self.n < min(target_atoms, self.max_atoms) and tries < 200:
            tries += 1
            cand = [i for i in range(self.n) if self.slack(i) >= 1]
            if not cand:
                break
            a = cand[int(self.rng.integers(len(cand)))]
            if self.rng.random() < 0.08 and self.n + 6 <= self.max_atoms:
                self.add_plain_ring(a, size=int(self.rng.choice([5, 6])))
                continue
            cls = int(self.rng.choice(self._DECOR_CLASSES,
                                      p=self._DECOR_PROBS))
            d = self.rng.normal(size=3)
            d /= np.linalg.norm(d) + 1e-12
            p = np.asarray(self.pos[a]) + _BOND_LEN * d
            b = self.add_atom(cls, p)
            if b is None:
                break
            self.add_bond(a, b, order=1)

    def upgrade_random_bonds(self) -> None:
        """Sprinkle double (and rare triple) bonds where valence allows."""
        for (i, j), order in list(self.bonds.items()):
            if order != 1:
                continue
            r = self.rng.random()
            if r < 0.10:
                self.upgrade_bond(i, j, 2)
            elif r < 0.11 and self.types[i] == _C and self.types[j] == _C:
                self.upgrade_bond(i, j, 3)

    def push_out_of_ex(self, ex_pos: np.ndarray,
                       min_d: float = 1.7, iters: int = 2) -> None:
        """Push non-pinned atoms radially out of EX spheres."""
        if ex_pos.size == 0:
            return
        for _ in range(iters):
            P = np.asarray(self.pos)
            for i in range(self.n):
                if self.pinned[i]:
                    continue
                delta = P[i] - ex_pos            # [E, 3]
                dist = np.linalg.norm(delta, axis=1)
                k = int(np.argmin(dist))
                if dist[k] < min_d:
                    dirv = delta[k] / (dist[k] + 1e-9)
                    self.pos[i] = ex_pos[k] + dirv * min_d

    # ----- export -----

    def finish(self) -> Tuple[np.ndarray, np.ndarray,
                              Optional[np.ndarray], Optional[np.ndarray]]:
        types = np.asarray(self.types, np.int32)
        pos = np.asarray(self.pos, np.float32)
        if not self.bonds:
            return types, pos, None, None
        src, dst, attr = [], [], []
        for (i, j), order in sorted(self.bonds.items()):
            src += [i, j]
            dst += [j, i]
            attr += [order, order]
        return (types, pos, np.asarray([src, dst], np.int64),
                np.asarray(attr, np.int64))


# --------------------------------------------------------------------------
# anchored growth from a (real) pharmacophore
# --------------------------------------------------------------------------

def _anchor_element(ptype: str, rng: np.random.Generator) -> int:
    if ptype == "HD":
        return _N if rng.random() < 0.6 else _O
    if ptype == "HA":
        return _O if rng.random() < 0.5 else _N
    if ptype == "HY":
        return _C
    if ptype == "MB":
        return int(rng.choice([_O, _N, _S]))
    if ptype == "PO":
        return _N
    if ptype == "NE":
        return _O
    if ptype.startswith("CV"):
        return _C if rng.random() < 0.7 else _S
    return _C


def grow_anchored(rng: np.random.Generator, phore: Phore,
                  max_atoms: int = MAX_ATOMS, size_mean: float = 23.0,
                  size_std: float = 6.0
                  ) -> Tuple[np.ndarray, np.ndarray,
                             Optional[np.ndarray], Optional[np.ndarray]]:
    """Grow a valence-valid connected molecule over a phore's typed points."""
    non_ex = [f for f in phore.features if f.type not in ("EX", "CR")]
    ex_pos = np.asarray([f.pos for f in phore.features if f.type == "EX"],
                        np.float64).reshape(-1, 3)
    mb = MolBuilder(rng, max_atoms)

    # anchor order: greedy nearest-neighbour walk over the feature points
    feats = list(non_ex)
    rng.shuffle(feats)
    ordered: List[PhoreFeature] = []
    if feats:
        cur = feats.pop()
        ordered.append(cur)
        while feats:
            dists = [np.linalg.norm(np.asarray(f.pos) - np.asarray(cur.pos))
                     for f in feats]
            cur = feats.pop(int(np.argmin(dists)))
            ordered.append(cur)

    prev_attach: Optional[int] = None
    for f in ordered:
        p = np.asarray(f.pos, np.float64)
        # leave a little headroom so the connecting chain always fits
        if mb.n + 8 > max_atoms:
            break
        # features lying on an already-grown atom reuse it as the anchor
        if mb.n:
            P = np.asarray(mb.pos)
            d = np.linalg.norm(P - p, axis=1)
            near = int(np.argmin(d))
            if d[near] < 1.1:
                prev_attach = near
                continue
        if f.type == "AR":
            attach = mb.add_aromatic_ring(
                p, np.asarray(f.norm) if f.has_norm else None)
        elif f.type == "XB":
            # halogen-bond donor: carbon at ~1.8 A, halogen on the point
            hal = int(rng.choice([_CL, _BR, _I]))
            d = np.asarray(f.norm) if f.has_norm and np.any(f.norm) \
                else rng.normal(size=3)
            d = d / (np.linalg.norm(d) + 1e-12)
            c_idx = mb.add_atom(_C, p - 1.8 * d, pinned=True)
            h_idx = mb.add_atom(hal, p, pinned=True)
            if c_idx is None or h_idx is None:
                break
            mb.add_bond(c_idx, h_idx)
            attach = c_idx
        else:
            attach = mb.add_atom(_anchor_element(f.type, rng), p,
                                 pinned=True)
        if attach is None:
            break
        if prev_attach is not None:
            mb.connect_chain(prev_attach, attach)
        prev_attach = attach

    if mb.n == 0:  # phore had no typed features at all
        mb.add_atom(_C, np.zeros(3))
        mb.decorate(int(rng.integers(MIN_ATOMS, 13)))

    # size signal: drug-like target (ZINC distribution), at least the
    # anchored scaffold plus a small margin — round-3 pools averaged 9-15
    # atoms under the old `anchors + U(2,14)` rule (VERDICT item 4)
    target = max(mb.n + int(rng.integers(2, 8)),
                 zinc_like_size(rng, max_atoms, size_mean, size_std))
    mb.decorate(min(target, max_atoms))
    mb.upgrade_random_bonds()
    mb.push_out_of_ex(ex_pos)
    return mb.finish()


# --------------------------------------------------------------------------
# free-growth molecule + derived pharmacophore (replaces the chain corpus)
# --------------------------------------------------------------------------

def grow_free(rng: np.random.Generator, n_atoms: int,
              max_atoms: int = MAX_ATOMS):
    """Branched/ring molecule with no conditioning anchors."""
    mb = MolBuilder(rng, min(max_atoms, max(n_atoms, MIN_ATOMS)))
    if rng.random() < 0.45 and n_atoms >= 8:
        mb.add_aromatic_ring(np.zeros(3))
    else:
        mb.add_atom(_C, np.zeros(3))
    mb.decorate(n_atoms)
    mb.upgrade_random_bonds()
    return mb.finish(), mb


def derive_phore(rng: np.random.Generator, mb: MolBuilder,
                 max_points: int, data_name: str = "zinc_300") -> Phore:
    """Reverse role-mapping from a built molecule to a pharmacophore, with
    EX shell sampling — the toolkit-free analogue of the reference LigPhore
    synthesis (`utils/phore_utils.py:222-295,455-536`)."""
    feats: List[PhoreFeature] = []
    pos = np.asarray(mb.pos, np.float32)
    ring_atoms = set(i for ring in mb.arom_rings for i in ring)
    for ring in mb.arom_rings:
        rp = pos[list(ring)]
        c = rp.mean(axis=0)
        x = rp - c
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        nrm = vt[-1] / (np.linalg.norm(vt[-1]) + 1e-12)
        feats.append(PhoreFeature("AR", 1.0, 1.0, 1.0, tuple(c), True,
                                  tuple(nrm), "0", 1.0))
    for i in range(mb.n):
        if i in ring_atoms:
            continue
        cls = mb.types[i]
        p = tuple(float(x) for x in pos[i])
        v = rng.normal(size=3)
        v /= np.linalg.norm(v) + 1e-12
        if cls == _N:
            t = "HD" if mb.order_sum[i] < 3 else "HA"
            feats.append(PhoreFeature(t, 0.7, 1.0, 1.0, p, True,
                                      tuple(v), "0", 1.0))
        elif cls == _O:
            t = "HA" if rng.random() < 0.7 else "HD"
            feats.append(PhoreFeature(t, 0.7, 1.0, 1.0, p, True,
                                      tuple(v), "0", 1.0))
        elif cls in (_CL, _BR, _I):
            feats.append(PhoreFeature("XB", 0.7, 1.0, 1.0, p, True,
                                      tuple(v), "0", 1.0))
        elif cls == _S:
            feats.append(PhoreFeature("MB", 1.0, 1.0, 1.0, p, False,
                                      (0.0, 0.0, 0.0), "0", 1.0))
        elif cls == _C and mb.order_sum[i] >= 3:
            feats.append(PhoreFeature("HY", 1.0, 1.0, 1.0, p, False,
                                      (0.0, 0.0, 0.0), "0", 1.0))
    rng.shuffle(feats)
    k = int(rng.integers(1, 9))
    chosen = feats[:max(1, min(k, len(feats)))]
    if not chosen:  # all-carbon chain with no roles: one HY on any atom
        chosen = [PhoreFeature("HY", 1.0, 1.0, 1.0,
                               tuple(float(x) for x in pos[0]), False,
                               (0.0, 0.0, 0.0), "0", 1.0)]
    # EX shell with real-data-like density (median real phore: ~85 EX)
    budget = max_points - len(chosen)
    num_ex = int(rng.integers(8, max(9, min(80, budget))))
    chosen = chosen + generate_ex_shell(chosen, pos, rng, low=2.0, up=4.5,
                                        num_ex=num_ex, clash_d=1.8,
                                        rounds=400)
    return Phore("derived", chosen)


# --------------------------------------------------------------------------
# RawSample assembly
# --------------------------------------------------------------------------

def _to_raw(phore: Phore, types, lpos, bidx, battr,
            data_name: str, name: str) -> RawSample:
    feats, ppos, pnorm, center = featurize_phore(phore, data_name,
                                                 norm_mode="new")
    return RawSample(
        lig_type=types, lig_pos=(lpos - center).astype(np.float32),
        bond_index=bidx, bond_attr=battr, phore_x=feats,
        phore_pos=(ppos - center).astype(np.float32), phore_norm=pnorm,
        center=center.astype(np.float32), name=name)


def real_phore_sample(rng: np.random.Generator, phore: Phore,
                      data_name: str = "zinc_300", max_phore: int = 96,
                      max_atoms: int = MAX_ATOMS,
                      size_mean: float = 23.0,
                      size_std: float = 6.0) -> RawSample:
    capped = cap_phore(phore, max_phore, rng)
    types, lpos, bidx, battr = grow_anchored(rng, capped, max_atoms,
                                             size_mean, size_std)
    return _to_raw(capped, types, lpos, bidx, battr, data_name,
                   f"real_{phore.name}")


def free_sample(rng: np.random.Generator, data_name: str = "zinc_300",
                max_phore: int = 96, max_atoms: int = MAX_ATOMS,
                n_atoms: Optional[int] = None, size_mean: float = 23.0,
                size_std: float = 6.0) -> RawSample:
    if n_atoms is None:
        n_atoms = zinc_like_size(rng, max_atoms, size_mean, size_std)
    (types, lpos, bidx, battr), mb = grow_free(rng, n_atoms, max_atoms)
    phore = derive_phore(rng, mb, max_phore, data_name)
    return _to_raw(phore, types, lpos, bidx, battr, data_name, "free")


_PHORE_CACHE: Dict[str, List[Phore]] = {}


def load_real_phores(include_sampling: bool = True) -> List[Phore]:
    key = f"all_{include_sampling}"
    if key not in _PHORE_CACHE:
        phores = []
        for path in list_real_phore_files(include_sampling):
            try:
                phores.append(parse_phore_file(path))
            except Exception as e:  # pragma: no cover - corrupt file guard
                print(f"[W] skipping {path}: {e}")
        _PHORE_CACHE[key] = phores
    return _PHORE_CACHE[key]


def mixed_corpus(seed: int, n_samples: int, data_name: str = "zinc_300",
                 max_phore: int = 96, max_atoms: int = MAX_ATOMS,
                 real_frac: float = 0.5,
                 phores: Optional[Sequence[Phore]] = None,
                 holdout: Optional[Sequence[str]] = None,
                 size_mean: float = 23.0, size_std: float = 6.0
                 ) -> List[RawSample]:
    """`n_samples` RawSamples: `real_frac` anchored to bundled real phores
    (cycled + re-grown with fresh randomness), the rest free-grown with
    derived phores. `holdout` names are excluded (eval-phore hygiene)."""
    rng = np.random.default_rng(seed)
    if phores is None:
        phores = load_real_phores()
    if holdout:
        hs = set(holdout)
        phores = [p for p in phores if p.name not in hs]
    out: List[RawSample] = []
    for i in range(n_samples):
        if phores and rng.random() < real_frac:
            ph = phores[int(rng.integers(len(phores)))]
            out.append(real_phore_sample(rng, ph, data_name, max_phore,
                                         max_atoms, size_mean, size_std))
        else:
            out.append(free_sample(rng, data_name, max_phore, max_atoms,
                                   size_mean=size_mean, size_std=size_std))
    return out
