"""Arithmetic the per-layer readers (``gpubench/metrics/<name>.py``) share.
A reader takes the run's record and returns its number, or None where the
record holds nothing to read; it never returns 0 for a share of a peak.

The record: the traced window's ``device_ops`` and ``kernels`` ([name,
start s, end s]), ``window_s`` and ``busy_s`` (``gpubench/tracing.py``);
``units``, the frames or fit steps the traced window completed; ``work``,
for a kernel (``"K1"``), the (operations, bytes) that each of its traced
launches needs, in launch order, None where not counted; ``peak_bytes``,
``torch.cuda.max_memory_allocated`` at the close of the measured window;
``unit_ms``, the host time of each frame of the measured window.
"""

from __future__ import annotations

from gpubench.counts.kernels import bound_s, kernel_of


def ms_per_unit(record, seconds: float):
    units = record.get("units") or 0
    return seconds / units * 1e3 if units else None


def other_device_ms(record):
    """Device ms a unit of every operation that is none of K1-K9."""
    return ms_per_unit(record, sum(e - s for name, s, e in
                                   record["device_ops"]
                                   if kernel_of(name) is None))


def launches(record):
    """Kernels a unit (copies and fills are not kernels)."""
    units = record.get("units") or 0
    return len(record["kernels"]) / units if units else None


def roofline(record, kernel: str):
    """Percent of ``kernel``'s traced time that its bound takes: the sum of
    max(operations / peak, bytes / peak) over its counted launches, over
    their device time."""
    events = [(s, e) for name, s, e in record["kernels"]
              if kernel_of(name) == kernel]
    work = record.get("work", {}).get(kernel)
    if not events or work is None or len(work) != len(events):
        return None
    pairs = [(w, e - s) for w, (s, e) in zip(work, events) if w is not None]
    spent = sum(d for _, d in pairs)
    if not pairs or spent <= 0.0:
        return None
    return 100.0 * sum(bound_s(*w) for w, _ in pairs) / spent


def idle_share(record):
    """Percent of the traced window in which no device operation ran."""
    if record["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])


def peak_mib(record):
    return record["peak_bytes"] / 2 ** 20

