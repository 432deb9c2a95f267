"""Blinn-Phong gradient shading against a directional light, and single
scattering.

Counterpart of ``volumerenderingproject_tpu/ops/phong.py:30-430``: the
normal is the normalised density gradient (``ops/conv3d``); ambient,
diffuse (|n.l|) and specular (|n.h|^shininess, h the half vector) terms
shade the classified colour; where the gradient is shorter than
:data:`GRAD_THRESHOLD` the shading fades to the unshaded colour.  The fused
marches take the same shading as per-voxel factor grids (M, S),
:func:`bake_light_grids`, with ``rgb * M + S`` in the kernel.

Single scattering (``config.scattering``) adds ``strength * HG(cos t; g) *
T_light * light.color`` to a sample's colour: the Henyey-Greenstein phase
(:func:`henyey_greenstein`) of the sample's material g and the angle
between the ray and the light, and the transmittance toward the light
(:func:`light_transmittance_grid`, a sheared plane sweep).  For a view
direction shared by every ray the whole term is a per-voxel quantity, which
:func:`bake_scatter_grid` folds into the S grid.

Vector lengths and dot products over the last axis of size 3 are summed
as ((x0 y0 + x1 y1) + x2 y2), the JAX package's order on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..utils.config import RenderConfig
from ..utils.device import const, resolve_device
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


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: at a bound each side of the
    tie takes half (``torch.clamp`` would pass all of it)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


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
    thr = const(float(GRAD_THRESHOLD), n_norm.device)
    return (n_norm / thr).clamp(0.0, 1.0)


def shade_directions(view_dir: torch.Tensor, light: Light
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l, h): the unit light direction and the unit half vector of
    :func:`phong_shade` for ``view_dir`` ([..., 3] or [3]), which depend on
    the ray and the light only: a scan takes them once a render."""
    l = light.direction / norm3(light.direction)
    v = view_dir / norm3(view_dir, keepdim=True).clamp_min(1e-8)
    h = l + v
    return l, h / norm3(h, keepdim=True).clamp_min(1e-8)


def phong_shade(rgb: torch.Tensor, normal: torch.Tensor,
                view_dir: torch.Tensor | None, light: Light,
                directions: Tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """Shade colours [..., 3] with normals [..., 3]; ``view_dir`` points
    from the sample toward the camera ([..., 3] or [3]), or ``directions``
    gives :func:`shade_directions` of it."""
    l, h = (shade_directions(view_dir, light) if directions is None
            else directions)
    n = normal
    n_norm = norm3(n, keepdim=True)
    n = n / n_norm.clamp_min(1e-8)
    ndotl = dot3(n, l, keepdim=True).abs()
    ndoth = dot3(n, h, keepdim=True).abs()
    spec = light.specular * safe_pow(ndoth, light.shininess)
    shaded = (light.ambient * rgb
              + light.diffuse * ndotl * rgb * light.color
              + spec * light.color)
    w = _fade(n_norm)
    return w * shaded + (1.0 - w) * rgb


def is_lit(config: RenderConfig, light: Light | None) -> bool:
    """Does this render shade (``config.lighting``, or an explicit light
    that does not only light the scattering, as the JAX scan decides;
    raycast.py:427)?"""
    return bool(config.lighting) or (light is not None
                                     and not config.scattering)


def uniform_light(light: Light | None) -> bool:
    """Is the light's colour the same in every channel (the default light's
    is)?  The bakes fold one colour into M and S."""
    if light is None:
        return True
    c = light.color.reshape(-1)
    return bool((c == c[0]).all())


def check_scatter_channels(channels: int) -> None:
    """Scattering classifies a per-voxel material, which a 4-D volume does
    not have: it raises, with the JAX package's reason, in every mode and
    in a fit."""
    if channels != 1:
        raise NotImplementedError(
            "config.scattering supports single-channel volumes (the "
            "multichannel sampler has no per-voxel material; "
            "raycast.py:254-262)")


def check_uniform_light(light: Light | None) -> None:
    """The fused a5 march shades through the bakes, which fold one light
    colour into M and S: an explicit light of another colour per channel
    raises, as the JAX package's a5 kernel does (pallas_a5.py:932-935)."""
    if not uniform_light(light):
        raise NotImplementedError(
            "the fused a5 march shades through the (M, S) bake, which folds "
            "one light colour, as the JAX package's a5 kernel does "
            "(pallas_a5.py:932-935); mode='scan' renders a light colour that "
            "is not uniform")


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


def random_directions(generator: torch.Generator, n: int,
                      device=None) -> torch.Tensor:
    """``n`` uniformly distributed unit vectors [n, 3] (phong.py:92-101):
    normalised Gaussian samples drawn from ``generator``.  The numbers are
    not the JAX package's, whose generator differs."""
    dev = resolve_device(device)
    v = torch.randn((n, 3), generator=generator, dtype=_f32,
                    device=generator.device).to(dev)
    return v / norm3(v, keepdim=True)


def henyey_greenstein(cos_theta: torch.Tensor, g: torch.Tensor
                      ) -> torch.Tensor:
    """The Henyey-Greenstein phase p(cos t; g) = (1 - g^2) / (4 pi (1 + g^2
    - 2 g cos t)^1.5), the denominator's base clamped at 1e-8
    (phong.py:103-112); g = 0 is the isotropic 1 / (4 pi)."""
    g = torch.as_tensor(g, dtype=_f32)
    cos_theta = torch.as_tensor(cos_theta, dtype=_f32, device=g.device)
    denom = (1.0 + g * g) - (2.0 * g) * cos_theta
    four_pi = const(float(np.float32(4.0 * math.pi)), g.device)
    return (1.0 - g * g) / (four_pi * denom.clamp_min(1e-8) ** 1.5)


def _unit(v: torch.Tensor) -> torch.Tensor:
    """``v / max(|v|, 1e-8)`` for a [3] vector."""
    return v / norm3(v).clamp_min(1e-8)


# the sweep's transposes: the light's dominant axis first (phong.py:384)
_SWEEP_PERMS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def sweep_axis(light_dir: torch.Tensor) -> Tuple[int, float]:
    """(axis, sign) of :func:`light_transmittance_grid`'s sweep: the light's
    dominant axis (|u| largest, the first on a tie) and the sign of u
    there, read on the host."""
    un = _unit(light_dir.detach().to(_f32)).cpu().numpy()
    axis = int(np.argmax(np.abs(un)))
    return axis, (-1.0 if un[axis] < 0 else 1.0)


def light_transmittance_grid(alpha: torch.Tensor, light_dir: torch.Tensor,
                             sweep: Tuple[int, float] | None = None
                             ) -> torch.Tensor:
    """Per-voxel transmittance toward a directional light, [X, Y, Z] f32:
    ``T(v) = prod (1 - alpha)^dl`` along the segment from voxel v to the
    volume's boundary in the direction ``light_dir`` (toward the light).

    The JAX package's sheared plane sweep (phong.py:296-393), with its
    per-plane operations in its order: along the light's dominant axis
    (|u| largest, the first on a tie) each plane's transmittance is the
    previous plane's running product resampled bilinearly at the constant
    shear offset u_perp / |u_axis| (1 beyond the volume), and the running
    product takes the plane's attenuation ``max(1 - alpha, 1e-9)^dl``, dl =
    1 / |u_axis|.  The (axis, sign) variant is chosen on the host
    (:func:`sweep_axis`; pass it as ``sweep`` under ``torch.func``
    transforms, which cannot read a tensor on the host); the result is
    differentiable in ``alpha`` and ``light_dir``."""
    dev = alpha.device
    u = _unit(light_dir.to(_f32))
    axis, sign = sweep_axis(light_dir) if sweep is None else sweep
    perm = _SWEEP_PERMS[axis]
    a = alpha.permute(perm)  # [A, B, C], swept over A
    inv = 1.0 / u[perm[0]].abs().clamp_min(1e-6)
    db = u[perm[1]] * inv
    dc = u[perm[2]] * inv
    na, nb, nc = a.shape
    att = torch.pow(torch.maximum(
        1.0 - a, torch.tensor(1e-9, dtype=_f32, device=dev)), inv)

    def offsets(d, n):
        x = d + torch.arange(n, dtype=_f32, device=dev)
        i = torch.floor(x)
        return i.detach().to(torch.int64), x - i

    ib, fb = offsets(db, nb)
    ic, fc = offsets(dc, nc)
    # the four bilinear taps read one gather of the running product padded
    # with ones (JAX's out-of-bounds value): |shear| <= 1 voxel, so the taps
    # of plane row j lie in rows j-1 .. j+2 (clamped into the padding)
    rows = torch.stack([ib, ib, ib + 1, ib + 1]).add(1).clamp(0, nb + 2)
    cols = torch.stack([ic, ic + 1, ic, ic + 1]).add(1).clamp(0, nc + 2)
    taps = rows[:, :, None] * (nc + 3) + cols[:, None, :]  # [4, B, C]
    weights = torch.stack([(1 - fb)[:, None] * (1 - fc)[None, :],
                           (1 - fb)[:, None] * fc[None, :],
                           fb[:, None] * (1 - fc)[None, :],
                           fb[:, None] * fc[None, :]])

    def resample(g):
        w = weights * torch.nn.functional.pad(
            g, (1, 2, 1, 2), value=1.0).reshape(-1)[taps]
        return ((w[0] + w[1]) + w[2]) + w[3]

    g = torch.ones((nb, nc), dtype=_f32, device=dev)
    planes = []
    for k in range(na):
        idx = na - 1 - k if sign > 0 else k
        t_k = resample(g)
        g = t_k * att[idx]
        planes.append(t_k)
    t = torch.stack(planes[::-1] if sign > 0 else planes)
    return t.permute(tuple(int(i) for i in np.argsort(perm)))


def light_transmittance_grid_slab(alpha: torch.Tensor,
                                  light_dir: torch.Tensor, x0: int,
                                  slab_x: int,
                                  sweep: Tuple[int, float] | None = None
                                  ) -> torch.Tensor:
    """The x-slab [x0, x0 + slab_x) of the whole volume's transmittance
    grid, [slab_x, Y, Z] (phong.py:114).  The JAX package stitches the
    slabs' sweeps across devices and documents the result as numerically
    identical to the whole volume's sweep (phong.py:120-125); every rank
    of the port holds the whole volume, so it sweeps ``alpha`` [X, Y, Z]
    whole (:func:`light_transmittance_grid`) and crops it."""
    return light_transmittance_grid(alpha, light_dir, sweep)[x0:x0 + slab_x]


def bake_scatter_grid(data: torch.Tensor, tf, config: RenderConfig,
                      light: Light, ray_dir: torch.Tensor,
                      cal_for_g: torch.Tensor, cal_max_trunc: torch.Tensor,
                      sweep: Tuple[int, float] | None = None
                      ) -> torch.Tensor:
    """Per-voxel single-scattering radiance [X, Y, Z] f32, ``strength *
    HG(cos t; g_voxel) * T_light(voxel) * light.color[0]``
    (pallas_march.py:1273-1312): with one ray direction for every ray
    (``ray_dir``: ortho a1 and every a5 march), the whole scattering add
    is a per-voxel quantity and folds into the S grid of ``rgb * M + S``.
    ``cal_for_g`` normalises the voxel for its material (g) lookup,
    trunc(cal_max) on a1 and the float cal_max on a5 (PARITY C4); the
    transmittance's alpha always takes ``cal_max_trunc``.  Its alpha is
    ``clip(alpha * config.density_scale, 0, 1)`` with ``jnp.clip``'s
    tangent at the bounds, so a fit differentiates it as the JAX package
    does.  Needs a uniform light colour.  ``sweep`` as in
    :func:`light_transmittance_grid`."""
    v = data.clamp_min(0.0)
    gk = tf.hg_g[tf.classify_index(v / cal_for_g)]
    alpha = tf.classify(v / cal_max_trunc)[..., 3]
    alpha = clip01(alpha * torch.tensor(config.density_scale, dtype=_f32,
                                        device=data.device))
    tgrid = light_transmittance_grid(alpha, light.direction, sweep)
    cos_t = dot3(_unit(ray_dir.to(_f32)), _unit(light.direction))
    ph = henyey_greenstein(cos_t, gk)
    strength = torch.tensor(config.scattering_strength, dtype=_f32,
                            device=data.device)
    return ((strength * ph) * tgrid) * light.color[0]
