"""Build the port's objects from numpy arrays of the same fields the JAX
package's pytrees hold, so both packages render identical inputs.

    volume_from_numpy(data, cal_max, dims)
    transfer_function_from_numpy(lower, upper, colors, hg_g)
    camera_from_numpy(position, front, right, up, top_left)
    light_from_numpy(direction, color, ambient, diffuse, specular, shininess)
    fit_params_from_numpy(tf_colors, density_scale, tf_lower, tf_upper,
                          light)
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


def fit_params_from_numpy(tf_colors, density_scale, tf_lower=None,
                          tf_upper=None, light=None, device=None) -> FitParams:
    """FitParams from the JAX package's ``FitParams`` fields: leaf tensors
    that require grad; the bounds and the light stay ``None`` unless given
    (``light`` as a mapping of the JAX ``Light``'s field names to
    arrays)."""
    dev = resolve_device(device)

    def leaf(a):
        return None if a is None else _f32(a, dev).requires_grad_()

    if light is not None:
        light = Light(*(t.requires_grad_() for t in light_from_numpy(
            **light, device=dev).fields()))
    return FitParams(tf_colors=leaf(tf_colors),
                     density_scale=leaf(density_scale),
                     tf_lower=leaf(tf_lower), tf_upper=leaf(tf_upper),
                     light=light)


def adam_state_from_numpy(optimizer: torch.optim.Optimizer, params: FitParams,
                          count, mu, nu) -> None:
    """Load optax's ``ScaleByAdamState`` into ``optimizer``'s state for
    ``params``: ``count`` steps taken, and the first and second moments
    ``mu``, ``nu`` as tuples of arrays in ``params.parameters()`` order:
    (tf_colors, density_scale), then (tf_lower, tf_upper) in a bound fit,
    then the light's six fields in a light fit (optax's leaf order)."""
    if not len(mu) == len(nu) == len(params.parameters()):
        raise ValueError("mu and nu need one array per parameter")
    for p, m, v in zip(params.parameters(), mu, nu):
        optimizer.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": _f32(m, p.device),
            "exp_avg_sq": _f32(v, p.device),
        }
