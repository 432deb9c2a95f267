"""Build the port's objects from numpy arrays of the same fields the JAX
package's pytrees hold, so both packages render identical inputs.

    volume_from_numpy(data, cal_max, dims)
    transfer_function_from_numpy(lower, upper, colors, hg_g)
    camera_from_numpy(position, front, right, up, top_left)
    light_from_numpy(direction, color, ambient, diffuse, specular, shininess)
    fit_params_from_numpy(tf_colors, density_scale)
    adam_state_from_numpy(optimizer, params, count, mu, nu)

Each takes ``device`` (CUDA unless given) or the device of what it fills.
Values are copied as float32 without rounding anything twice.
"""

from __future__ import annotations

import numpy as np
import torch

from .diff.fit import FitParams
from .ingest.volume import Volume
from .ops.phong import Light
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


def light_from_numpy(direction, color, ambient, diffuse, specular, shininess,
                     device=None) -> Light:
    """The port's ``Light`` from the JAX ``Light``'s fields: direction and
    color [3], the four coefficients 0-d."""
    dev = resolve_device(device)
    return Light(*(_f32(v, dev) for v in (direction, color, ambient, diffuse,
                                          specular, shininess)))


def fit_params_from_numpy(tf_colors, density_scale, device=None) -> FitParams:
    """FitParams from the JAX package's ``FitParams`` fields: leaf tensors
    that require grad."""
    dev = resolve_device(device)
    return FitParams(tf_colors=_f32(tf_colors, dev).requires_grad_(),
                     density_scale=_f32(density_scale, dev).requires_grad_())


def adam_state_from_numpy(optimizer: torch.optim.Optimizer, params: FitParams,
                          count, mu, nu) -> None:
    """Load optax's ``ScaleByAdamState`` into ``optimizer``'s state for
    ``params``: ``count`` steps taken, and the first and second moments
    ``mu``, ``nu`` as (tf_colors, density_scale) pairs of arrays."""
    for p, m, v in zip(params.parameters(), mu, nu):
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": _f32(m, p.device),
            "exp_avg_sq": _f32(v, p.device),
        }
