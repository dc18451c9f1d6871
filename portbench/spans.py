"""The program's own spans in a traced run: the `record_function` ranges
that `phoregen_tpu_torch/` opens (`sample.step` and its children, the
train step's phases, `stack.backward`, the loader's), which
`trace.events` puts in the host list beside the aten ops and the CUDA
runtime calls, on the device trace's clock.

The idle labels of `trace.idle_gaps` look back a bounded number of host
ops, so they never reach a span that opened earlier in the step; the
functions here search the spans alone, with no such bound. A span on the
autograd worker thread (`stack.backward`) has no parent by nesting there:
it is inside whichever span's interval holds it.
"""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Sequence, Tuple

from . import trace
from .trace import Event

# the spans the program opens
PROGRAM_SPANS = ("sample.step", "sample.network", "sample.posterior",
                 "sample.guidance", "sample.position", "train.forward",
                 "train.backward", "train.clip", "train.adam", "train.ema",
                 "stack.backward", "data.batch", "data.to_device")
# the runtime calls in which the host waits for the device
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize")
OUTSIDE = "outside every span"


def named(host: Sequence[Event], names: Iterable[str]) -> List[Event]:
    """The events whose name is one of `names` (a string is one name),
    by start."""
    names = {names} if isinstance(names, str) else set(names)
    return sorted((e for e in host if e[0] in names), key=lambda e: e[1])


def total_us(host: Sequence[Event], names: Iterable[str]) -> float:
    """Summed duration of the events named."""
    return sum(e - s for _, s, e in named(host, names))


def inside_us(host: Sequence[Event], outer: Sequence[Event],
              names: Iterable[str]) -> List[float]:
    """For each event of `outer`, the summed time of the events named
    `names` that begin inside its interval (cut at its end)."""
    calls = named(host, names)
    starts = [s for _, s, _ in calls]
    out = []
    for _, s, e in outer:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_left(starts, e)
        out.append(sum(min(ce, e) - cs for _, cs, ce in calls[lo:hi]))
    return out


def by_span(host: Sequence[Event], names: Iterable[str],
            intervals: Sequence[Tuple[float, float]]) -> List[List]:
    """[label, seconds]: the intervals' time summed by the innermost span
    named `names` (the latest-starting of those open) when each interval
    began, or `OUTSIDE`; largest first."""
    spans = named(host, names)
    starts = [s for _, s, _ in spans]
    reach, m = [], float("-inf")     # the latest end up to each span
    for _, _, e in spans:
        m = max(m, e)
        reach.append(m)
    tot: Dict[str, float] = {}
    for s, e in intervals:
        label = OUTSIDE
        k = bisect.bisect_right(starts, s) - 1
        while k >= 0 and reach[k] > s:
            if spans[k][2] > s:
                label = spans[k][0]
                break
            k -= 1
        tot[label] = tot.get(label, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])]


def idle_by_span(dev: Sequence[Event], host: Sequence[Event],
                 names: Iterable[str] = PROGRAM_SPANS) -> List[List]:
    """The device's idle gaps, in seconds, by the innermost program span
    open when each gap began (aten ops and runtime calls are not
    spans)."""
    return by_span(host, names, trace.gaps(dev))

