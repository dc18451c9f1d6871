"""Random draws of a whole batch, or of some of its rows.

Every random number of a training step or of a reverse process is drawn
at a shape whose leading axis is the batch. `BatchRows(generator, start,
stop, total)` stands for a `torch.Generator` whose holder keeps rows
[start, stop) of a batch of `total`: each draw is made at the whole
batch's shape and those rows are returned, so they come out as in one
process that drew the whole batch. A data-parallel rank takes its rows of
a step's draws this way (`train/step.py`), and a sampling shard its rows
of the pool's (`sample/pipeline.py`), as the JAX package draws once for a
batch sharded over its mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BatchRows:
    """Rows [start, stop) of a batch of `total` drawn from `generator`."""
    generator: torch.Generator
    start: int
    stop: int
    total: int


def batch_extent(generator, rows: int
                 ) -> Tuple[Optional[torch.Generator], int, Optional[slice]]:
    """(the torch generator, the batch size to draw at, the rows to keep;
    None = all) for a draw whose leading axis holds `rows` rows."""
    if not isinstance(generator, BatchRows):
        return generator, rows, None
    if rows != generator.stop - generator.start:
        raise ValueError(f"a draw of {rows} rows from BatchRows "
                         f"[{generator.start}, {generator.stop})")
    return (generator.generator, generator.total,
            slice(generator.start, generator.stop))


def _draw(fn, shape, generator, device, dtype):
    shape = tuple(shape)
    gen, total, rows = batch_extent(generator, shape[0])
    out = fn((total,) + shape[1:], generator=gen, device=device, dtype=dtype)
    return out if rows is None else out[rows]


def randn(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of `shape` (leading axis: the batch)."""
    return _draw(torch.randn, shape, generator, device, dtype)


def rand(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) draws of `shape` (leading axis: the batch)."""
    return _draw(torch.rand, shape, generator, device, dtype)
