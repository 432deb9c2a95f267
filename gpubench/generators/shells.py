"""A seeded brain-like volume on the device: nested ellipsoid shells whose
intensities fall in the empty, bone, brain and muscle intervals of the
reference app's default transfer function, plus Gaussian noise that
straddles the interval bounds (the port's ``mni_like_volume``, in
``chip_smoke.py``, made on the device in a few large calls).

Parameters (a configuration's ``volume``): ``dims`` [X, Y, Z], ``radii``
(the outer shell's semi-axes in voxels), ``base`` (the intensity outside
it), ``shells`` ([relative radius, intensity] from the outside in) and
``noise_sigma``.
"""

from __future__ import annotations

import torch


def make(p: dict, seed: int, device) -> torch.Tensor:
    """float32 [X, Y, Z] on ``device`` from ``seed``."""
    dims = tuple(int(d) for d in p["dims"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    r2 = None
    for axis, (d, radius) in enumerate(zip(dims, p["radii"])):
        c = (torch.arange(d, dtype=torch.float32, device=device)
             - (d - 1) / 2.0) / float(radius)
        shape = [1, 1, 1]
        shape[axis] = d
        term = (c * c).reshape(shape)
        r2 = term if r2 is None else r2 + term
    r = torch.sqrt(r2)
    vol = torch.full(dims, float(p["base"]), dtype=torch.float32,
                     device=device)
    for rel, value in p["shells"]:
        vol = torch.where(r < float(rel), float(value), vol)
    noise = torch.randn(dims, generator=gen, dtype=torch.float32,
                        device=device)
    return vol + float(p["noise_sigma"]) * noise
