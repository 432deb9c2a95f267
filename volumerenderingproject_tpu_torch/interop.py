"""Build the port's objects from numpy arrays of the same fields the JAX
package's pytrees hold, so both packages render identical inputs.

    volume_from_numpy(data, cal_max, dims)
    transfer_function_from_numpy(lower, upper, colors, hg_g)
    camera_from_numpy(position, front, right, up, top_left)

Each takes ``device`` (CUDA unless given).  Values are copied as float32
without rounding anything twice.
"""

from __future__ import annotations

import numpy as np
import torch

from .ingest.volume import Volume
from .scene.camera import Camera
from .scene.transfer_function import TransferFunction
from .utils.device import resolve_device


def _f32(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def volume_from_numpy(data, cal_max, dims=None, cal_min=0.0,
                      pixdim=(1.0, 1.0, 1.0), device=None) -> Volume:
    dev = resolve_device(device)
    arr = _f32(data, dev)
    dims = tuple(int(d) for d in (dims if dims is not None else arr.shape[:3]))
    if tuple(arr.shape[:3]) != dims:
        raise ValueError(f"data shape {tuple(arr.shape)} does not match dims {dims}")
    channels = int(arr.shape[3]) if arr.ndim == 4 else 1
    return Volume(data=arr, cal_max=_f32(cal_max, dev),
                  cal_min=_f32(cal_min, dev), pixdim=_f32(pixdim, dev),
                  dims=dims, channels=channels)


def transfer_function_from_numpy(lower, upper, colors, hg_g,
                                 device=None) -> TransferFunction:
    dev = resolve_device(device)
    return TransferFunction(lower=_f32(lower, dev), upper=_f32(upper, dev),
                            colors=_f32(colors, dev), hg_g=_f32(hg_g, dev))


def camera_from_numpy(position, front, right, up, top_left,
                      device=None) -> Camera:
    dev = resolve_device(device)
    return Camera(*(_f32(v, dev) for v in (position, front, right, up,
                                           top_left)))
