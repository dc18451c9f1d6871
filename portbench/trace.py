"""The device trace of a traced run, reduced to what the per-layer
metrics read: device kernel events, the busy time (the union of their
intervals, so that overlapping kernels count once), the traced window,
the operations that took most time and the longest idle gaps labelled by
what the host was doing when the device ran dry.

`profile()` wraps `torch.profiler` (CPU and CUDA activities); `events()`
turns a finished profile into plain tuples, so that the arithmetic below
runs on any list of events (the tests give it synthetic ones).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

# (name, start_us, end_us)
Event = Tuple[str, float, float]


def profile():
    from torch.profiler import ProfilerActivity, profile as _profile
    return _profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA])


def events(prof) -> Tuple[List[Event], List[Event]]:
    """(device kernel events, host op events) of a finished profile,
    times in microseconds on the profiler's clock. Memory copies and sets
    are device work too and count as kernels here."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        if kind == "CUDA":
            # kernels, copies and sets; not the ranges that mirror host
            # annotations on the device's timeline
            act = getattr(e, "activity_type", None)
            act = str(act()).lower() if act else ""
            if not e.is_user_annotation() and "annotation" not in act:
                dev.append((e.name(), start, end))
        elif kind == "CPU":
            host.append((e.name(), start, end))
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return dev, host


def busy_us(dev: Sequence[Event]) -> float:
    """Length of the union of the events' intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window_us(dev: Sequence[Event]) -> float:
    """From the first device event's start to the last one's end."""
    if not dev:
        return 0.0
    return max(e for _, _, e in dev) - min(s for _, s, _ in dev)


def gaps(dev: Sequence[Event]) -> List[Tuple[float, float]]:
    """(start, end) of every interval inside the window in which no
    device event ran."""
    out, cur_e = [], None
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def host_label(host: Sequence[Event], t: float, starts=None,
               reach: int = 256) -> str:
    """The innermost host op running at time `t` (the latest-starting of
    those that cover it, looking back at most `reach` ops), or 'host
    idle'. `host` is sorted by start; `starts` are its starts."""
    starts = starts if starts is not None else [s for _, s, _ in host]
    k = bisect.bisect_right(starts, t) - 1
    for j in range(k, max(k - reach, -1), -1):
        if host[j][2] > t:
            return host[j][0]
    return "host idle"


def top_ops(dev: Sequence[Event], n: int = 10) -> List[List]:
    """[name, seconds] of the device operations with most total time."""
    tot: Dict[str, float] = {}
    for name, s, e in dev:
        tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(dev: Sequence[Event], host: Sequence[Event], n: int = 10
              ) -> List[List]:
    """[label, seconds]: the idle time of the device summed by what the
    host was doing when each gap began, largest first."""
    tot: Dict[str, float] = {}
    host = sorted(host, key=lambda x: x[1])
    starts = [s for _, s, _ in host]
    for s, e in gaps(dev):
        k = host_label(host, s, starts)
        tot[k] = tot.get(k, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def kernel_time_us(dev: Sequence[Event], fragments: Sequence[str]) -> float:
    """Summed time of the device events whose name holds any fragment."""
    return sum(e - s for name, s, e in dev
               if any(f in name for f in fragments))
