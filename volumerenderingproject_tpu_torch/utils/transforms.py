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
    """``jnp.cross`` as XLA compiles it on the CPU: each component one
    fused multiply-add, ``fma(a_i, b_j, -(a_k * b_l))``, taken in float64
    (the product of two float32 is exact there) and rounded once, the same
    on the CPU and the GPU.  Rounding both products first leaves the JAX
    package's cross by up to an ulp of the products where they cancel
    (a view matrix's near-zero entry), which moves a voxel of the point
    cloud that lies on a pixel's edge to the next pixel."""
    a = _t(a)
    b = _t(b, a)
    f64 = torch.float64

    def fma_sub(i, j, k, m):
        prod = (a[..., k] * b[..., m]).to(f64)
        return (a[..., i].to(f64) * b[..., j].to(f64) - prod).to(_f32)

    return torch.stack([fma_sub(1, 2, 2, 1), fma_sub(2, 0, 0, 2),
                        fma_sub(0, 1, 1, 0)], dim=-1)


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


def scaling(v, device=None) -> torch.Tensor:
    """Pure (anisotropic) scaling matrix."""
    m = identity(device)
    v = _t(v, m).reshape(3)
    m[0, 0], m[1, 1], m[2, 2] = v[0], v[1], v[2]
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


def scale(m, v) -> torch.Tensor:
    """``glm::scale(m, v) == m @ scaling(v)``."""
    m = _t(m)
    return matmul(m, scaling(v, m.device))


def rotate(m, angle_rad, axis) -> torch.Tensor:
    """``glm::rotate(m, angle, axis) == m @ rotation(angle, axis)``."""
    return matmul(_t(m), rotation(angle_rad, axis))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def look_at(eye, center, up) -> torch.Tensor:
    """glm::lookAt (right-handed): the view matrix looking from ``eye`` at
    ``center``."""
    eye = _t(eye).reshape(3)
    f = normalize(_t(center, eye).reshape(3) - eye)
    s = normalize(cross(f, _t(up, eye).reshape(3)))
    u = cross(s, f)
    zero = torch.zeros(1, dtype=_f32, device=eye.device)
    return torch.stack([
        torch.cat([s, -_dot3(s, eye).reshape(1)]),
        torch.cat([u, -_dot3(u, eye).reshape(1)]),
        torch.cat([-f, _dot3(f, eye).reshape(1)]),
        torch.cat([zero, zero, zero, zero + 1.0]),
    ])


def inverse(m) -> torch.Tensor:
    """General 4x4 inverse by glm::inverse's cofactor formula (the
    reference's own inverse, kernel.cu:1197-1198), written out op by op so
    that the CPU and the GPU give the same float32 matrix without a trip to
    the host.  It can differ from an LU inverse in the last bits."""
    g = _t(m).T  # glm indexes m[column][row]
    coef = {}
    for name, (c1, r1, c2, r2, c3, r3, c4, r4) in {
            "00": (2, 2, 3, 3, 3, 2, 2, 3), "02": (1, 2, 3, 3, 3, 2, 1, 3),
            "03": (1, 2, 2, 3, 2, 2, 1, 3), "04": (2, 1, 3, 3, 3, 1, 2, 3),
            "06": (1, 1, 3, 3, 3, 1, 1, 3), "07": (1, 1, 2, 3, 2, 1, 1, 3),
            "08": (2, 1, 3, 2, 3, 1, 2, 2), "10": (1, 1, 3, 2, 3, 1, 1, 2),
            "11": (1, 1, 2, 2, 2, 1, 1, 2), "12": (2, 0, 3, 3, 3, 0, 2, 3),
            "14": (1, 0, 3, 3, 3, 0, 1, 3), "15": (1, 0, 2, 3, 2, 0, 1, 3),
            "16": (2, 0, 3, 2, 3, 0, 2, 2), "18": (1, 0, 3, 2, 3, 0, 1, 2),
            "19": (1, 0, 2, 2, 2, 0, 1, 2), "20": (2, 0, 3, 1, 3, 0, 2, 1),
            "22": (1, 0, 3, 1, 3, 0, 1, 1), "23": (1, 0, 2, 1, 2, 0, 1, 1),
    }.items():
        coef[name] = g[c1, r1] * g[c2, r2] - g[c3, r3] * g[c4, r4]

    def fac(a, b, c):
        return torch.stack([coef[a], coef[a], coef[b], coef[c]])

    fac0, fac1, fac2 = fac("00", "02", "03"), fac("04", "06", "07"), \
        fac("08", "10", "11")
    fac3, fac4, fac5 = fac("12", "14", "15"), fac("16", "18", "19"), \
        fac("20", "22", "23")

    def vec(r):
        return torch.stack([g[1, r], g[0, r], g[0, r], g[0, r]])

    vec0, vec1, vec2, vec3 = vec(0), vec(1), vec(2), vec(3)
    sign_a = _t([1.0, -1.0, 1.0, -1.0], g)
    sign_b = _t([-1.0, 1.0, -1.0, 1.0], g)
    inv0 = ((vec1 * fac0 - vec2 * fac1) + vec3 * fac2) * sign_a
    inv1 = ((vec0 * fac0 - vec2 * fac3) + vec3 * fac4) * sign_b
    inv2 = ((vec0 * fac1 - vec1 * fac3) + vec3 * fac5) * sign_a
    inv3 = ((vec0 * fac2 - vec1 * fac4) + vec2 * fac5) * sign_b
    cols = torch.stack([inv0, inv1, inv2, inv3])  # glm columns
    dot0 = g[0] * cols[:, 0]
    det = (dot0[0] + dot0[1]) + (dot0[2] + dot0[3])
    one_over_det = torch.ones((), dtype=_f32, device=g.device) / det
    return (cols * one_over_det).T


def ortho(left, right, bottom, top, znear, zfar, device=None
          ) -> torch.Tensor:
    """glm::ortho, the orthographic projection (myApp.cu:182), each entry
    a float32 quotient as the JAX package takes it."""
    left, right, bottom, top, znear, zfar = (
        torch.tensor(float(x), dtype=_f32, device=device)
        for x in (left, right, bottom, top, znear, zfar))
    two = torch.tensor(2.0, dtype=_f32, device=device)
    m = torch.zeros((4, 4), dtype=_f32, device=device)
    m[0, 0] = two / (right - left)
    m[1, 1] = two / (top - bottom)
    m[2, 2] = -two / (zfar - znear)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(zfar + znear) / (zfar - znear)
    m[3, 3] = 1.0
    return m


def apply(m, p) -> torch.Tensor:
    """Apply a homogeneous transform to point(s) of shape (3,) or (..., 3)."""
    m = _t(m)
    p = _t(p, m)
    r = m[:3, :3]
    return (p[..., 0:1] * r[:, 0] + p[..., 1:2] * r[:, 1]
            + p[..., 2:3] * r[:, 2] + m[:3, 3])
