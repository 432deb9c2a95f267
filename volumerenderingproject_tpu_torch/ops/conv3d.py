"""Separable 3-D stencils: Gaussian pre-smoothing and the gradient fields
whose directions are the Phong normals (``ops/phong.py``).

Counterpart of ``volumerenderingproject_tpu/ops/conv3d.py:62-145``.  Each
1-D pass is a zero-padded shift-and-add in the JAX package's tap order, not
``torch.nn.functional.conv3d``: another summation order moves a normal by
ulps, and a normal decides the shading of every sample in its voxel.
"""

from __future__ import annotations

import numpy as np
import torch

_f32 = torch.float32


def gaussian_kernel1d(sigma: float, radius: int | None = None,
                      device=None) -> torch.Tensor:
    """Normalised Gaussian taps [2r + 1], computed in float64 and rounded
    once to float32; ``radius`` defaults to max(1, int(3 sigma + 0.5))."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return torch.tensor((k / k.sum()).astype(np.float32), device=device)


def _correlate1d(volume: torch.Tensor, k: torch.Tensor,
                 axis: int) -> torch.Tensor:
    """Zero-padded SAME 1-D cross-correlation along ``axis``:
    ``out[i] = sum_j k[j] * v[i + j - r]``, added tap by tap from j = 0."""
    n = int(k.shape[0])
    r = n // 2
    v = volume.to(_f32)
    length = v.shape[axis]
    k = k.to(device=v.device, dtype=_f32)
    out = torch.zeros_like(v)
    for j in range(n):
        off = j - r  # out[i] += k[j] * v[i + off], zero outside
        dst = [slice(None)] * 3
        src = [slice(None)] * 3
        dst[axis] = slice(max(0, -off), length - max(0, off))
        src[axis] = slice(max(0, off), length + min(0, off))
        # in place on the rows the tap reaches: elsewhere it adds k * 0
        out[tuple(dst)] += k[j] * v[tuple(src)]
    return out


def gaussian_smooth(volume: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian smoothing: three 1-D passes, x then y then z."""
    k = gaussian_kernel1d(sigma, device=volume.device)
    out = volume.to(_f32)
    for axis in range(3):
        out = _correlate1d(out, k, axis)
    return out


def central_difference_gradient(volume: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient [X, Y, Z, 3], 0.5 (v[i+1] - v[i-1]),
    zero outside the volume."""
    k = torch.tensor([-0.5, 0.0, 0.5], dtype=_f32, device=volume.device)
    return torch.stack([_correlate1d(volume, k, axis) for axis in range(3)],
                       dim=-1)


def sobel_gradient(volume: torch.Tensor) -> torch.Tensor:
    """Sobel gradient [X, Y, Z, 3]: per axis, the difference taps along it
    and the [1, 2, 1] / 4 smoothing taps along the other two, in axis
    order."""
    d = torch.tensor([-0.5, 0.0, 0.5], dtype=_f32, device=volume.device)
    s = torch.tensor([0.25, 0.5, 0.25], dtype=_f32, device=volume.device)
    grads = []
    for axis in range(3):
        out = volume.to(_f32)
        for ax2 in range(3):
            out = _correlate1d(out, d if ax2 == axis else s, ax2)
        grads.append(out)
    return torch.stack(grads, dim=-1)


def gradient_field(volume: torch.Tensor, gradient_filter: str = "central",
                   presmooth_sigma: float = 0.0) -> torch.Tensor:
    """The normal field [X, Y, Z, 3] of a render config: optional Gaussian
    pre-smoothing, then central-difference or Sobel gradients."""
    if presmooth_sigma > 0.0:
        volume = gaussian_smooth(volume, presmooth_sigma)
    if gradient_filter == "sobel":
        return sobel_gradient(volume)
    if gradient_filter == "central":
        return central_difference_gradient(volume)
    raise ValueError(f"unknown gradient_filter {gradient_filter!r}")
