"""The traced window: ``torch.profiler`` around a fixed amount of the cell's
work, reduced to what the per-layer readers and the result's ``breakdown``
read: every device operation (name, start, end in seconds), the host
operations that were open while the device idled, the window's length by
the host clock, and the union of the device's busy intervals."""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

# host operations scanned back from a gap for the one still open
_SCAN_BACK = 4000
# idle intervals shorter than this are not named (their total still counts)
_MIN_GAP_S = 2e-6


def _is_memop(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def capture(fn: Callable[[], None]) -> dict:
    """Run ``fn`` (which ends with the device synchronised) under the
    profiler -> the record the readers take (``device_ops``, ``kernels``,
    ``window_s``, ``busy_s``, ``idle_gaps``, ``top_ops``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev: List[Tuple[str, float, float]] = []
    host: List[Tuple[float, float, str]] = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and (
                e.device_type.name != "CPU"):
            continue
        rng = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type.name == "CUDA":
            dev.append((e.name, *rng))
        else:
            host.append((rng[0], rng[1], e.name))
    dev.sort(key=lambda x: x[1])
    host.sort()
    return reduce(dev, host, window_s)


def busy_intervals(dev) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, in order."""
    out: List[Tuple[float, float]] = []
    for _, s, e in dev:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _open_at(host, starts, t: float) -> str:
    """The innermost host operation open at ``t`` (the latest started of
    those not yet ended), or ``python`` where none is."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _SCAN_BACK), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "python"


def reduce(dev, host, window_s: float) -> dict:
    busy = busy_intervals(dev)
    busy_s = sum(e - s for s, e in busy)
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 >= _MIN_GAP_S:
            gaps[_open_at(host, starts, 0.5 * (e0 + s1))] += s1 - e0
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        device_ops=dev,
        kernels=[op for op in dev if not _is_memop(op[0])],
        window_s=window_s, busy_s=busy_s,
        top_ops=[[n, s] for n, s in top],
        idle_gaps=[[n, s] for n, s in idle])
