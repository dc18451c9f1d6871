"""Device time inside the program's spans: the profiler's device-side
ranges of `record_function` spans (a range from the first to the last
device operation launched inside the span, named as the span), which
`trace.events` leaves out of its device list on purpose, and the device's
busy time that falls inside them.

`ranges(prof)` reads them from a finished profile; the arithmetic below
runs on plain (name, start_us, end_us) tuples, so that the tests can give
it synthetic ones.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .trace import Event


def ranges(prof) -> List[Event]:
    """The device-side ranges of the spans of a finished profile, by
    start, times in microseconds on the profiler's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).rsplit(".", 1)[-1] != "CUDA":
            continue
        act = getattr(e, "activity_type", None)
        act = str(act()).lower() if act else ""
        if e.is_user_annotation() or "annotation" in act:
            start = e.start_ns() / 1e3
            out.append((e.name(), start, start + e.duration_ns() / 1e3))
    out.sort(key=lambda x: x[1])
    return out


def union(intervals: Sequence[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of intervals, as disjoint (start, end) by start."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap_us(a: Sequence[Tuple[float, float]],
               b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two unions of disjoint intervals,
    each sorted by start."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def busy_inside_us(dev: Sequence[Event], rng: Sequence[Event]
                   ) -> Dict[str, float]:
    """{span: the device's busy time (the union of the device events'
    intervals) inside the union of that span's device-side ranges}."""
    busy = union([(s, e) for _, s, e in dev])
    names = sorted({n for n, _, _ in rng})
    return {n: overlap_us(busy, union([(s, e) for m, s, e in rng if m == n]))
            for n in names}


def per_step_ms(dev: Sequence[Event], rng: Sequence[Event], steps: int
                ) -> Dict[str, float]:
    """{span: device busy ms inside it, a step}."""
    return {n: t / 1e3 / steps for n, t in busy_inside_us(dev, rng).items()}
