"""Blinn-Phong gradient shading against a directional light.

Counterpart of ``volumerenderingproject_tpu/ops/phong.py:30-91, 394-430``:
the normal is the normalised density gradient (``ops/conv3d``); ambient,
diffuse (|n.l|) and specular (|n.h|^shininess, h the half vector) terms
shade the classified colour; where the gradient is shorter than
:data:`GRAD_THRESHOLD` the shading fades to the unshaded colour.  The fused
marches take the same shading as per-voxel factor grids (M, S),
:func:`bake_light_grids`, with ``rgb * M + S`` in the kernel.

Vector lengths and dot products over the last axis of size 3 are summed
as ((x0 y0 + x1 y1) + x2 y2), the JAX package's order on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.config import RenderConfig
from ..utils.device import resolve_device
from . import conv3d

_f32 = torch.float32
# gradient length below which shading fades out (homogeneous media have no
# surface normal); the scan and the bake share it
GRAD_THRESHOLD = 1e-3
_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
           "shininess")
# direction 3, color 3, ambient, diffuse, specular, shininess
N_LIGHT_PARAMS = 10


@dataclasses.dataclass(frozen=True)
class Light:
    """Directional light and Phong coefficients: ``direction`` [3] (world
    space, any length), ``color`` [3], and 0-d ``ambient``, ``diffuse``,
    ``specular``, ``shininess``."""

    direction: torch.Tensor
    color: torch.Tensor
    ambient: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor

    def to(self, device) -> "Light":
        return Light(*(getattr(self, k).to(device) for k in _FIELDS))

    def fields(self) -> Tuple[torch.Tensor, ...]:
        """The six tensors in the JAX pytree's leaf order."""
        return tuple(getattr(self, k) for k in _FIELDS)


def default_light(device=None) -> Light:
    dev = resolve_device(device)

    def t(v):
        return torch.tensor(v, dtype=_f32, device=dev)

    return Light(direction=t([0.5, 1.0, 0.75]), color=t([1.0, 1.0, 1.0]),
                 ambient=t(0.35), diffuse=t(0.55), specular=t(0.25),
                 shininess=t(16.0))


def light_to_vec(light: Light) -> torch.Tensor:
    """The light as a [10] f32 vector; inverse of :func:`light_from_vec`."""
    return torch.cat([getattr(light, k).to(_f32).reshape(-1)
                      for k in _FIELDS])


def light_from_vec(v: torch.Tensor) -> Light:
    return Light(direction=v[0:3], color=v[3:6], ambient=v[6], diffuse=v[7],
                 specular=v[8], shininess=v[9])


def dot3(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False
         ) -> torch.Tensor:
    """Dot product over the last axis (size 3), ((a0 b0 + a1 b1) + a2 b2)."""
    d = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    return d[..., None] if keepdim else d


def norm3(a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean length over the last axis (size 3), its square root
    correctly rounded: taken in float64 and rounded once (the vectorised
    float32 ``torch.sqrt`` on the CPU is an ulp off on some inputs, which
    ``|n.h|^shininess`` magnifies shininess-fold)."""
    return torch.sqrt(dot3(a, a, keepdim).double()).to(_f32)


def safe_pow(base: torch.Tensor, exponent) -> torch.Tensor:
    """``base ** exponent`` for base >= 0, 0 where base == 0, the base
    clamped to 1e-6 inside the power (a NaN-free derivative in the
    exponent)."""
    b = base.clamp_min(1e-6)
    return torch.where(base > 0.0, b**exponent,
                       torch.zeros((), dtype=base.dtype, device=base.device))


def _fade(n_norm: torch.Tensor) -> torch.Tensor:
    """The shading weight clip(|g| / GRAD_THRESHOLD, 0, 1)."""
    # a device divisor: CUDA divides by a host scalar as a reciprocal product
    thr = torch.tensor(GRAD_THRESHOLD, dtype=_f32, device=n_norm.device)
    return (n_norm / thr).clamp(0.0, 1.0)


def phong_shade(rgb: torch.Tensor, normal: torch.Tensor,
                view_dir: torch.Tensor, light: Light) -> torch.Tensor:
    """Shade colours [..., 3] with normals [..., 3]; ``view_dir`` points
    from the sample toward the camera ([..., 3] or [3])."""
    l = light.direction / norm3(light.direction)
    n = normal
    n_norm = norm3(n, keepdim=True)
    n = n / n_norm.clamp_min(1e-8)
    ndotl = dot3(n, l, keepdim=True).abs()
    v = view_dir / norm3(view_dir, keepdim=True).clamp_min(1e-8)
    h = l + v
    h = h / norm3(h, keepdim=True).clamp_min(1e-8)
    ndoth = dot3(n, h, keepdim=True).abs()
    spec = light.specular * safe_pow(ndoth, light.shininess)
    shaded = (light.ambient * rgb
              + light.diffuse * ndotl * rgb * light.color
              + spec * light.color)
    w = _fade(n_norm)
    return w * shaded + (1.0 - w) * rgb


def is_lit(config: RenderConfig, light: Light | None) -> bool:
    """Does this render shade (``config.lighting``, or an explicit light,
    as the JAX scan decides; raycast.py:427)?"""
    return bool(config.lighting) or light is not None


def check_uniform_light(light: Light | None) -> None:
    """The bake folds one light colour into M and S: an explicit light of
    another colour per channel raises, naming its ROADMAP.md item."""
    if light is not None:
        c = light.color.reshape(-1)
        if not bool((c == c[0]).all()):
            raise NotImplementedError(
                "a non-uniform light colour in the fused marches is not "
                "ported yet: ROADMAP.md item 9 (K1's in-kernel lighting "
                "variant); mode='scan' renders it")


def bake_light_grids(data: torch.Tensor, config: RenderConfig, light: Light,
                     view_dir: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-voxel Blinn-Phong factors (M, S), each [X, Y, Z] f32, on the
    gradient field of ``config`` (filter and presmoothing): shading a
    classified colour is ``rgb * M + S`` (pallas_march.py:1225-1270).
    Needs a uniform ``light.color`` and a view direction shared by every
    sample."""
    grad = conv3d.gradient_field(data, config.gradient_filter,
                                 config.presmooth_sigma)
    return bake_light_grids_from_grad(grad, light, view_dir)


def bake_light_grids_from_grad(grad: torch.Tensor, light: Light,
                               view_dir: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shading half of :func:`bake_light_grids`, from a gradient field
    [..., 3] (pallas_march.py:1249-1270):
    M = 1 - w + w (ambient + diffuse |n.l| c), S = w specular |n.h|^shin c,
    w = clip(|g| / GRAD_THRESHOLD, 0, 1), c = light.color[0]."""
    ldir = light.direction / norm3(light.direction)
    n_norm = norm3(grad)
    nn = grad / n_norm[..., None].clamp_min(1e-8)
    ndotl = dot3(nn, ldir).abs()
    v = view_dir / norm3(view_dir).clamp_min(1e-8)
    h = ldir + v
    h = h / norm3(h).clamp_min(1e-8)
    ndoth = dot3(nn, h).abs()
    w = _fade(n_norm)
    lc = light.color[0]
    m = 1.0 - w + w * (light.ambient + light.diffuse * ndotl * lc)
    s = w * light.specular * safe_pow(ndoth, light.shininess) * lc
    return m.contiguous(), s.contiguous()


def bake_light_vec(grad: torch.Tensor, light_vec: torch.Tensor,
                   view_dir: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, S) of the light vector ``light_vec`` [10] (:func:`light_to_vec`)
    on the gradient field ``grad`` [X, Y, Z, 3], with the light colour
    collapsed to its channel mean first, as the JAX package's
    light-differentiable bake does (pallas_march_vjp.py:1129-1135): the
    same grids for a uniform colour, and equal gradients for the three
    colour components."""
    lg = light_from_vec(light_vec)
    mean = lg.color.mean().expand(3)
    return bake_light_grids_from_grad(
        grad, dataclasses.replace(lg, color=mean), view_dir)


def bake_tangents(data: torch.Tensor, config: RenderConfig,
                  light_vec: torch.Tensor, view_dir: torch.Tensor,
                  grad: torch.Tensor | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-mode derivatives of :func:`bake_light_vec` along each of the
    :data:`N_LIGHT_PARAMS` light parameters -> (dM, dS), each
    [10, X, Y, Z] f32: ``jax.jvp`` of the JAX bake with a one-hot tangent,
    for every parameter at once (``torch.func.jvp`` under ``vmap``).  The
    gradient field does not depend on the light; pass ``grad`` where it is
    already built."""
    if grad is None:
        grad = conv3d.gradient_field(data, config.gradient_filter,
                                     config.presmooth_sigma)
    light_vec = light_vec.detach().to(_f32)
    basis = torch.eye(N_LIGHT_PARAMS, dtype=_f32, device=light_vec.device)

    def tangent(e):
        return torch.func.jvp(
            lambda v: bake_light_vec(grad, v, view_dir), (light_vec,),
            (e,))[1]

    with torch.no_grad():
        dm, ds = torch.func.vmap(tangent)(basis)
    return dm.contiguous(), ds.contiguous()
