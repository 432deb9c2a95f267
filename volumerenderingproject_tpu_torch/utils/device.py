"""Device selection for the port's entry points.

Every entry point runs on the GPU unless the caller names another device.
A missing GPU is an error, never a quiet move to the CPU.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means CUDA, which must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@functools.lru_cache(maxsize=1024)
def _const(value, dtype, device) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=device)


def const(value, device, dtype=torch.float32) -> torch.Tensor:
    """The tensor of a host constant (a float or a tuple of them), made once
    per (value, dtype, device) and shared: callers must not write to it.  A
    tensor made from host values on a CUDA device is a copy that waits for
    the device's queue, which the scans' per-sample arithmetic paid several
    times a sample."""
    return _const(value, dtype, torch.device(device))
