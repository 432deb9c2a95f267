"""The samplers: the a1 nearest-voxel lookup, the a5 colour-space corners
and the smooth-mode trilinear intensity sample.

The a1 sampler gives the value semantics of the reference's min/max octree
query (Octree.cu:158-183), which is a nearest-voxel lookup of the centered
dataset at the query's dyadic cell.

float32 parity, one C expression per step:
  - ``k = floor(p * 2^d)``: a power-of-two product is exact;
  - ``res = (k / 2^d) * L``: one rounding, as in updateNode (Octree.cu:85-88);
  - a centered-range check on ``res``, then ``trunc((res + dim/2) - L/2)``
    (Octree.cu:91-100); every /2 constant is an exact half;
  - negative values clamp to 0 (the descent starts from res = 0,
    Octree.cu:172-177).
"""

from __future__ import annotations

from typing import Tuple

import torch

_f32 = torch.float32


def octree_nn_index(
    dims: Tuple[int, int, int],
    depth: int,
    p: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat voxel index, valid mask) for unit-cube points ``p`` (..., 3).

    ``flat`` is clamped into range so it is always safe to gather with;
    ``valid`` is False outside the root cube [0,1)^3 or outside the centered
    dataset extent (where the sample value is 0).
    """
    d1, d2, d3 = dims
    L = torch.tensor(float(max(dims)), dtype=_f32, device=p.device)
    n = float(2**depth)
    dimv = torch.tensor([d1, d2, d3], dtype=_f32, device=p.device)

    p = p.to(_f32)
    inside_root = ((p >= 0.0) & (p < 1.0)).all(dim=-1)
    k = torch.floor(p * n)
    res = (k / n) * L
    half_gap = L / 2.0 - dimv / 2.0
    in_dataset = ((res >= half_gap) & (res < half_gap + dimv)).all(dim=-1)
    ijk = torch.trunc((res + dimv / 2.0) - L / 2.0).to(torch.int64)
    flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
    flat = flat.clamp(0, d1 * d2 * d3 - 1)
    return flat, inside_root & in_dataset


def octree_nn_sample(
    volume_flat: torch.Tensor,
    dims: Tuple[int, int, int],
    depth: int,
    p: torch.Tensor,
) -> torch.Tensor:
    """Intensities at unit-cube points ``p`` (..., 3), a1 semantics: 0
    outside the root cube or the centered dataset, negatives clamped."""
    flat, valid = octree_nn_index(dims, depth, p)
    vals = volume_flat[flat].clamp_min(0.0)
    return torch.where(valid, vals, torch.zeros((), dtype=_f32, device=p.device))


# Corner offsets in the a5 kernel's fetch order (kernel.cu:129-159):
# X1..X8 = (0,0,0),(0,0,1),(0,1,0),(0,1,1),(1,0,0),(1,0,1),(1,1,0),(1,1,1)
_A5_OFFSETS = (
    (0.0, 0.0, 0.0),
    (0.0, 0.0, 1.0),
    (0.0, 1.0, 0.0),
    (0.0, 1.0, 1.0),
    (1.0, 0.0, 0.0),
    (1.0, 0.0, 1.0),
    (1.0, 1.0, 0.0),
    (1.0, 1.0, 1.0),
)


def corner_flat_indices(dims: Tuple[int, int, int], pos: torch.Tensor
                        ) -> torch.Tensor:
    """The 8 corners' flat voxel indices (..., 8) int64 for a5
    interpolation: each offset is added in float before the per-axis
    truncation (kernel.cu:129-159), so ``trunc(x + 1)`` and not
    ``trunc(x) + 1``.  Nothing is clamped: a y+1 or z+1 tap at the last
    row wraps into the next row, and the caller guards ``flat < total``."""
    _, d2, d3 = dims
    q = pos.to(_f32)[..., None, :] + torch.tensor(_A5_OFFSETS, dtype=_f32,
                                                  device=pos.device)
    ijk = torch.trunc(q).to(torch.int64)
    return ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]


def corner_intensities(volume_flat: torch.Tensor,
                       dims: Tuple[int, int, int],
                       pos: torch.Tensor) -> torch.Tensor:
    """The 8 corner intensities for a5 interpolation, shape (..., 8); a
    corner at ``flat >= total`` reads 0 (the reference's only guard)."""
    d1, d2, d3 = dims
    total = d1 * d2 * d3
    flat = corner_flat_indices(dims, pos)
    vals = volume_flat[flat.clamp(0, total - 1)]
    return torch.where(flat < total, vals,
                       torch.zeros((), dtype=_f32, device=pos.device))


def trilinear_mix_colors(colors8: torch.Tensor, frac: torch.Tensor
                         ) -> torch.Tensor:
    """Mix 8 corner RGBAs (..., 8, 4) with fractions (..., 3), y->x->z order
    (kernel.cu:161-175)."""
    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    fz = frac[..., 2:3]
    c = colors8
    cy1 = c[..., 0, :] * (1.0 - fy) + c[..., 2, :] * fy
    cy2 = c[..., 1, :] * (1.0 - fy) + c[..., 3, :] * fy
    cy3 = c[..., 4, :] * (1.0 - fy) + c[..., 6, :] * fy
    cy4 = c[..., 5, :] * (1.0 - fy) + c[..., 7, :] * fy
    cz1 = cy1 * (1.0 - fx) + cy3 * fx
    cz2 = cy2 * (1.0 - fx) + cy4 * fx
    return cz1 * (1.0 - fz) + cz2 * fz


def trilinear_color_sample(volume_flat: torch.Tensor,
                           dims: Tuple[int, int, int], pos: torch.Tensor,
                           classify_fn, cal_max: torch.Tensor) -> torch.Tensor:
    """a5/TEST sample colour at voxel-space positions (..., 3) -> (..., 4):
    each corner classified through the TF (by the float ``cal_max``, no
    negative clamp), the colours mixed; TF(0)'s colour outside [0, dims)
    (kernel.cu:117)."""
    pos = pos.to(_f32)
    dimv = torch.tensor(dims, dtype=_f32, device=pos.device)
    inside = ((pos >= 0.0) & (pos < dimv)).all(dim=-1)
    intens = corner_intensities(volume_flat, dims, pos)
    colors8 = classify_fn(intens / cal_max)
    frac = pos - torch.trunc(pos)  # `difference` kernel.cu:127
    mixed = trilinear_mix_colors(colors8, frac)
    outside_color = classify_fn(torch.zeros_like(cal_max))
    return torch.where(inside[..., None], mixed, outside_color)


def trilinear_intensity_sample(volume: torch.Tensor, pos: torch.Tensor
                               ) -> torch.Tensor:
    """Smooth-mode intensity at voxel-space positions ``pos`` (..., 3):
    zero-padded trilinear interpolation of ``volume`` [X, Y, Z] (or
    [X, Y, Z, C], giving (..., C)).  Corners at ``floor(pos)`` and +1, each
    read through its clipped flat index and zeroed out of range; the mix
    runs z, then y, then x (the JAX package's ``trilinear_intensity_sample``
    op for op).  No reference counterpart: the reference interpolates
    colours only."""
    d1, d2, d3 = volume.shape[:3]
    vol = volume.reshape(d1 * d2 * d3, -1)
    pos = pos.to(_f32)
    base = torch.floor(pos)
    frac = pos - base
    basei = base.to(torch.int32).to(torch.int64)
    zero = torch.zeros((), dtype=_f32, device=pos.device)

    def fetch(ox, oy, oz):
        ix = basei[..., 0] + ox
        iy = basei[..., 1] + oy
        iz = basei[..., 2] + oz
        ok = ((ix >= 0) & (ix < d1) & (iy >= 0) & (iy < d2) & (iz >= 0)
              & (iz < d3))
        flat = (ix.clamp(0, d1 - 1) * (d2 * d3) + iy.clamp(0, d2 - 1) * d3
                + iz.clamp(0, d3 - 1))
        return torch.where(ok[..., None], vol[flat], zero)

    fx = frac[..., 0:1]
    fy = frac[..., 1:2]
    fz = frac[..., 2:3]
    c00 = fetch(0, 0, 0) * (1 - fz) + fetch(0, 0, 1) * fz
    c01 = fetch(0, 1, 0) * (1 - fz) + fetch(0, 1, 1) * fz
    c10 = fetch(1, 0, 0) * (1 - fz) + fetch(1, 0, 1) * fz
    c11 = fetch(1, 1, 0) * (1 - fz) + fetch(1, 1, 1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    return out.squeeze(-1) if out.shape[-1] == 1 else out
