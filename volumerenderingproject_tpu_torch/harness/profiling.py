"""Profiling and tracing, formalizing the reference's stdout stage timers
(myApp.cu:885-907: updatePrimaryRayDirection / getSampleColors /
blendSampleColors; the octree build time, myApp.cu:308-312):

  * :class:`StageTimer` — named wall-clock stages with a report table; the
    device is synchronized before and after each stage, so a stage's time
    includes the work it queued.
  * :func:`trace` — a ``torch.profiler`` context (CPU and, where CUDA is
    available, CUDA activities) that writes a Chrome trace
    (``trace.json``, open in chrome://tracing or Perfetto) to ``log_dir``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Tuple

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    def __init__(self) -> None:
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as stage ``name``; it may put its results in the
        yielded dict (kept alive until the stage's end)."""
        _sync()
        t0 = time.perf_counter()
        out: dict = {}
        try:
            yield out
        finally:
            _sync()
            self.stages.append((name, time.perf_counter() - t0))

    def record(self, name: str, seconds: float) -> None:
        self.stages.append((name, seconds))

    def report(self) -> str:
        width = max((len(n) for n, _ in self.stages), default=5)
        lines = [f"{n:<{width}}  {t * 1e3:10.2f} ms" for n, t in self.stages]
        total = sum(t for _, t in self.stages)
        lines.append(f"{'total':<{width}}  {total * 1e3:10.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    to ``log_dir/trace.json``; yields the profiler (its
    ``key_averages()`` has the per-operator times)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
