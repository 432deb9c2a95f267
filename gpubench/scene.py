"""A cell's inputs, made by the benchmark from its configuration and
``--seed``, and handed alike to the program and to the reference: the
volume (by the generator its configuration names, on the device), the
transfer function, the light and the orbit's cameras."""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch


def volume(spec: dict, seed: int, device) -> torch.Tensor:
    """The configuration's ``volume`` from ``gpubench/generators/<name>.py``."""
    gen = importlib.import_module(f"gpubench.generators.{spec['generator']}")
    return gen.make(spec, seed, device)


def transfer_function(spec: dict, device) -> dict:
    """float32 tensors ``lower``, ``upper`` [K], ``colors`` [K, 4], ``hg_g``
    [K]: bounds and rgb given on the 0-255 scale, alpha on 0-1."""
    f = np.float32
    lower = [f(v / 255.0) for v in spec["lower_255"]]
    upper = [f(v / 255.0) for v in spec["upper_255"]]
    colors = [[f(c / 255.0) for c in rgba[:3]] + [f(rgba[3])]
              for rgba in spec["colors"]]

    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return dict(lower=t(lower), upper=t(upper), colors=t(colors),
                hg_g=t([0.0] * len(lower)))


LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")


def light(spec: dict, device, **override) -> dict:
    """float32 tensors of the light's six fields, with ``override``."""
    vals = dict(spec, **override)
    return {k: torch.tensor(vals[k], dtype=torch.float32, device=device)
            for k in LIGHT_FIELDS}


def orbit_view(theta: float, radius: float = 1.5, y0: float = 0.4,
               y_amp: float = 0.2) -> np.ndarray:
    """float32 [5, 3]: position, front, right, up and top-left corner of
    the camera at angle ``theta`` of bench.py's orbit (bench.py:116-135):
    position (r cos t, y0 + y_amp sin 2t, r sin t), looking at the origin,
    world up +y, a 2 x 2 screen (utils.h:41-46, 68-70), in float64 and
    rounded once."""
    pos = np.array([radius * math.cos(theta),
                    y0 + y_amp * math.sin(2.0 * theta),
                    radius * math.sin(theta)])
    front = -pos / np.linalg.norm(pos)
    right = np.cross(front, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, front)
    up /= np.linalg.norm(up)
    top_left = pos - right + up
    return np.stack([pos, front, right, up, top_left]).astype(np.float32)
