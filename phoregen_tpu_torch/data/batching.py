"""Padded fixed-shape batches and bucketing.

Counterpart of `phoregen_tpu/data/batching.py`: each sample is padded to a
static (ligand bucket, max phore) shape on the host in numpy; bonds live on
the dense [NL, NL] grid. `PhoreGraphBatch.to(device)` moves a host batch
to torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class PhoreGraphBatch:
    lig_type: object    # [B, NL] int atom class ids (0 where padded)
    lig_pos: object     # [B, NL, 3] f32
    lig_mask: object    # [B, NL] bool
    bond_type: object   # [B, NL, NL] int dense directed bond classes
    phore_x: object     # [B, NP, FP] f32
    phore_pos: object   # [B, NP, 3] f32 (centered frame)
    phore_norm: object  # [B, NP, 3] f32 unit vectors (0 if none)
    phore_mask: object  # [B, NP] bool
    center: object      # [B, 3] f32 original phore COM

    @property
    def num_graphs(self) -> int:
        return self.lig_type.shape[0]

    @property
    def num_lig_slots(self) -> int:
        return self.lig_type.shape[1]

    @property
    def bond_mask(self):
        """[B, NL, NL] directed pair validity (off-diagonal, both real)."""
        m = self.lig_mask
        NL = self.num_lig_slots
        if isinstance(m, torch.Tensor):
            eye = torch.eye(NL, dtype=torch.bool, device=m.device)
        else:
            eye = np.eye(NL, dtype=bool)
        return m[:, :, None] & m[:, None, :] & ~eye

    def to(self, device) -> "PhoreGraphBatch":
        return PhoreGraphBatch(**{
            f.name: torch.as_tensor(np.asarray(getattr(self, f.name))).to(
                device) for f in dataclasses.fields(self)})


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


def pad_sample(lig_type: np.ndarray, lig_pos: np.ndarray,
               bond_index: np.ndarray, bond_attr: np.ndarray,
               phore_x: np.ndarray, phore_pos: np.ndarray,
               phore_norm: np.ndarray, center: np.ndarray,
               n_lig: int, n_phore: int):
    """Pad one parsed sample to (n_lig, n_phore) numpy arrays (host side)."""
    nl = len(lig_type)
    nph = len(phore_x)
    assert nl <= n_lig, f"ligand {nl} > bucket {n_lig}"
    assert nph <= n_phore, f"phore {nph} > max_phore {n_phore}"
    out = {}
    out["lig_type"] = np.zeros(n_lig, np.int32)
    out["lig_type"][:nl] = lig_type
    out["lig_pos"] = np.zeros((n_lig, 3), np.float32)
    out["lig_pos"][:nl] = lig_pos
    out["lig_mask"] = np.zeros(n_lig, bool)
    out["lig_mask"][:nl] = True
    bt = np.zeros((n_lig, n_lig), np.int32)
    if bond_index is not None and bond_index.size:
        bt[bond_index[0], bond_index[1]] = bond_attr
    out["bond_type"] = bt
    fp = phore_x.shape[-1]
    out["phore_x"] = np.zeros((n_phore, fp), np.float32)
    out["phore_x"][:nph] = phore_x
    out["phore_pos"] = np.zeros((n_phore, 3), np.float32)
    out["phore_pos"][:nph] = phore_pos
    out["phore_norm"] = np.zeros((n_phore, 3), np.float32)
    out["phore_norm"][:nph] = phore_norm
    out["phore_mask"] = np.zeros(n_phore, bool)
    out["phore_mask"][:nph] = True
    out["center"] = np.asarray(center, np.float32)
    return out


def collate(samples: List[dict]) -> PhoreGraphBatch:
    """Stack padded host samples into a batch of host numpy arrays."""
    stack = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return PhoreGraphBatch(**stack)


def replicate_phore(sample: dict, n_graphs: int,
                    lig_counts: np.ndarray, n_lig: int) -> PhoreGraphBatch:
    """Build a sampling batch: one pharmacophore replicated n_graphs times
    with per-graph ligand atom counts (reference `models/diffusion.py:396-399`).
    """
    out = []
    for i in range(n_graphs):
        s = dict(sample)
        n = int(lig_counts[i])
        s = {**s}
        s["lig_type"] = np.zeros(n_lig, np.int32)
        s["lig_pos"] = np.zeros((n_lig, 3), np.float32)
        s["lig_mask"] = np.zeros(n_lig, bool)
        s["lig_mask"][:n] = True
        s["bond_type"] = np.zeros((n_lig, n_lig), np.int32)
        out.append(s)
    return collate(out)
