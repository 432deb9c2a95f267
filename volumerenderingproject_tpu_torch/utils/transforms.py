"""Homogeneous 4x4 transform helpers (torch, float32): the glm subset the
camera uses.

Matrices are in the mathematical convention: ``apply(M, p) == (M @ [p, 1])[:3]``
(glm's column-major ``M * vec4(p, 1)``).  ``translate``/``rotate`` right
multiply like glm (``glm::translate(m, v) == m @ T``).

Every product is written out as separate multiplies and left-to-right adds.
Eager PyTorch runs each as its own elementwise op, so no multiply-add is
fused and the result is the same on the CPU and the GPU, in full float32
(the counterpart of the JAX package's ``Precision.HIGHEST`` pins).
"""

from __future__ import annotations

import torch

_f32 = torch.float32


def _t(x, like: torch.Tensor | None = None) -> torch.Tensor:
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=_f32, device=device)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 1/sqrt(x), taken in float64 and rounded once: the correctly
    rounded value, identical on the CPU and the GPU (CUDA's ``rsqrtf`` is
    approximate, and 1/sqrt in float32 rounds twice)."""
    return (1.0 / torch.sqrt(x.to(torch.float64))).to(x.dtype)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """glm::normalize: v * inversesqrt(dot(v, v)), no zero guard."""
    v = _t(v)
    s = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * rsqrt(s)[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = _t(a)
    b = _t(b, a)
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=_f32, device=device)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """4x4 (or [..., n, k] @ [k, m]) product as k multiply-add passes."""
    a = _t(a)
    b = _t(b, a)
    out = a[..., :, 0:1] * b[0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[k:k + 1, :]
    return out


def translation(v, device=None) -> torch.Tensor:
    m = identity(device)
    m[:3, 3] = _t(v, m).reshape(3)
    return m


def rotation(angle_rad, axis) -> torch.Tensor:
    """Rotation about ``axis`` by ``angle_rad`` (glm::rotate semantics; the
    axis is normalized)."""
    axis = normalize(_t(axis).reshape(3))
    ang = _t(angle_rad, axis)
    c = torch.cos(ang)
    s = torch.sin(ang)
    t = 1.0 - c
    x, y, z = axis[0], axis[1], axis[2]
    r = torch.stack([
        torch.stack([t * x * x + c, t * x * y - s * z, t * x * z + s * y]),
        torch.stack([t * x * y + s * z, t * y * y + c, t * y * z - s * x]),
        torch.stack([t * x * z - s * y, t * y * z + s * x, t * z * z + c]),
    ])
    m = identity(axis.device)
    m[:3, :3] = r
    return m


def translate(m, v) -> torch.Tensor:
    """``glm::translate(m, v) == m @ translation(v)``."""
    m = _t(m)
    return matmul(m, translation(v, m.device))


def rotate(m, angle_rad, axis) -> torch.Tensor:
    """``glm::rotate(m, angle, axis) == m @ rotation(angle, axis)``."""
    return matmul(_t(m), rotation(angle_rad, axis))


def apply(m, p) -> torch.Tensor:
    """Apply a homogeneous transform to point(s) of shape (3,) or (..., 3)."""
    m = _t(m)
    p = _t(p, m)
    r = m[:3, :3]
    return (p[..., 0:1] * r[:, 0] + p[..., 1:2] * r[:, 1]
            + p[..., 2:3] * r[:, 2] + m[:3, 3])
