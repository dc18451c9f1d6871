"""Bucketed host input pipeline (numpy).

Counterpart of `phoregen_tpu/data/loader.py`, the same batches from the
same seed:
- samples are stored unpadded (`RawSample`) and padded at batch-assembly
  time to the smallest ligand bucket that fits the batch's largest
  molecule, so a loader produces a small, bounded set of shapes;
- batches are assembled within a bucket group and the batch order is
  shuffled per epoch with a seeded generator.
Batches are host numpy arrays; `PhoreGraphBatch.to(device)` moves one to
the device. In a process group (`parallel/group.py`) every rank computes
the same seeded global order and assembles only its slice of each batch,
as the JAX package's processes do.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
from torch.profiler import record_function

from ..config import Config
from ..parallel import group
from .batching import (SLOTS, PhoreGraphBatch, collate, pad_sample,
                       pick_bucket, triplet_count)
from .transforms import add_phore_noise


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


class PhoreDataLoader:
    """Iterable over PhoreGraphBatch with per-epoch shuffling + bucketing."""

    def __init__(self, samples: Sequence[RawSample], config: Config,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 augment: bool = False, drop_last: Optional[bool] = None):
        self.config = config
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.augment = augment
        self.drop_last = shuffle if drop_last is None else drop_last
        self.epoch = 0
        self.buckets = sorted(config.dataset.ligand_buckets)
        self.max_phore = config.dataset.max_phore
        # filter oversize molecules / pharmacophores up front (the reference
        # filters > max_atom at dataset load, `datasets/phoregen.py:37`)
        max_lig = min(self.buckets[-1], config.dataset.max_atom)
        self.samples = []
        n_dropped = 0
        for s in samples:
            if s.n_atoms > max_lig or len(s.phore_x) > self.max_phore:
                n_dropped += 1
                continue
            self.samples.append(s)
        if n_dropped:
            print(f"[W] loader: dropped {n_dropped}/{len(list(samples))} "
                  f"samples over max_atoms={max_lig} or "
                  f"max_phore={self.max_phore}")

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        """Exact batch count: batches form within bucket groups, so count per
        group (shuffling permutes order, not group membership sizes)."""
        counts = {}
        for s in self.samples:
            b = pick_bucket(s.n_atoms, self.buckets)
            counts[b] = counts.get(b, 0) + 1
        total = 0
        for n in counts.values():
            if self.drop_last:
                total += n // self.batch_size
            else:
                total += (n + self.batch_size - 1) // self.batch_size
        return total

    def _batch_indices(self, rng: np.random.Generator) -> List[tuple]:
        """Returns (indices, real_size) pairs; real_size < batch_size marks a
        cycled tail batch whose metrics must be down-weighted."""
        order = np.arange(len(self.samples))
        if self.shuffle:
            rng.shuffle(order)
        # group by bucket so one batch pads to one static shape
        by_bucket = {}
        for i in order:
            b = pick_bucket(self.samples[i].n_atoms, self.buckets)
            by_bucket.setdefault(b, []).append(i)
        batches = []
        for b, idxs in by_bucket.items():
            for s in range(0, len(idxs), self.batch_size):
                chunk = idxs[s:s + self.batch_size]
                real = len(chunk)
                if real < self.batch_size:
                    if self.drop_last:
                        continue
                    # pad the tail batch by cycling (static shape preserved);
                    # the real size rides along so eval means stay exact
                    chunk = (chunk * ((self.batch_size // real) + 1)
                             )[:self.batch_size]
                batches.append((np.asarray(chunk), real))
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _assemble(self, idxs: np.ndarray, rng: np.random.Generator,
                  rows: slice = slice(None)) -> PhoreGraphBatch:
        """Pad and collate the members `rows` of the batch `idxs`. The
        augmentation noise is drawn for every member in order, so a
        rank's rows are those of the whole batch."""
        with record_function("data.batch"):
            tcfg = self.config.train
            members = [self.samples[i] for i in idxs]
            n_lig = pick_bucket(max(m.n_atoms for m in members), self.buckets)
            keep = range(len(members))[rows]
            padded = []
            for j, m in enumerate(members):
                ppos, pnorm = m.phore_pos, m.phore_norm
                if self.augment and tcfg.add_phore_noise:
                    ppos, pnorm = add_phore_noise(
                        rng, ppos, pnorm, tcfg.phore_noise_std,
                        tcfg.phore_norm_angle)
                if j not in keep:
                    continue
                padded.append(pad_sample(
                    m.lig_type, m.lig_pos, m.bond_index, m.bond_attr,
                    m.phore_x, ppos, pnorm, m.center, n_lig, self.max_phore))
                SLOTS["lig_real"] += m.n_atoms
                SLOTS["trip_real"] += triplet_count(m.n_atoms)
            SLOTS["lig_slots"] += len(padded) * n_lig
            SLOTS["trip_slots"] += len(padded) * n_lig ** 3
            return collate(padded)

    def __iter__(self) -> Iterator[PhoreGraphBatch]:
        for batch, _ in self.iter_with_sizes():
            yield batch

    def iter_with_sizes(self) -> Iterator[tuple]:
        """Yields (batch, real_size); real_size < batch_size only for a
        cycled tail batch (duplicates must not skew per-epoch means). In a
        process group the batch is this rank's slice of the global batch
        (`group.local_batch_slice`); real_size stays the global one."""
        rng = np.random.default_rng(self.seed + self.epoch)
        for idxs, real in self._batch_indices(rng):
            yield self._assemble(idxs, rng,
                                 group.local_batch_slice(len(idxs))), real
