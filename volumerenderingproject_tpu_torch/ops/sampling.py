"""The samplers: the a1 nearest-voxel lookup, the a5 colour-space corners
and the smooth-mode trilinear intensity sample, and their x-slab variants
for the volume-axis slab scan (``parallel/render_dist.py``).

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

from ..utils.device import const

_f32 = torch.float32


def _octree_ijk(dims: Tuple[int, int, int], depth: int, p: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(voxel ijk (..., 3) int64, unclamped; valid mask) of the a1 chain."""
    d1, d2, d3 = dims
    L = const(float(max(dims)), p.device)
    n = float(2**depth)
    dimv = const((float(d1), float(d2), float(d3)), p.device)

    p = p.to(_f32)
    inside_root = ((p >= 0.0) & (p < 1.0)).all(dim=-1)
    k = torch.floor(p * n)
    res = (k / n) * L
    half_gap = L / 2.0 - dimv / 2.0
    in_dataset = ((res >= half_gap) & (res < half_gap + dimv)).all(dim=-1)
    ijk = torch.trunc((res + dimv / 2.0) - L / 2.0).to(torch.int64)
    return ijk, inside_root & in_dataset


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
    ijk, valid = _octree_ijk(dims, depth, p)
    flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
    flat = flat.clamp(0, d1 * d2 * d3 - 1)
    return flat, valid


class _Take(torch.autograd.Function):
    """``table[idx]`` of a 1-D table whose backward adds the cotangents
    with ``index_add_`` (atomics on CUDA, so their order is not fixed):
    indexing's own backward accumulates each index's duplicates one after
    another, and every ray off the volume reads the same clamped index."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.n, dtype=g.dtype, device=g.device)
        return out.index_add_(0, idx.reshape(-1), g.reshape(-1)), None


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a 1-D per-voxel table (the transmittance grid);
    under autograd its gradient goes through :class:`_Take`."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Take.apply(table, idx)
    return table[idx]


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
    q = pos.to(_f32)[..., None, :] + const(_A5_OFFSETS, pos.device)
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
    dimv = const(tuple(float(d) for d in dims), pos.device)
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


# ---------------------------------------------------------------------------
# x-slab samplers for the volume-axis slab scan (sampling.py:105-449).  A
# slab [x0, x0 + slab_x) owns every sample whose x-clamped voxel index it
# holds, off the volume too, so each sample is owned by exactly one slab;
# the others classify it as the over identity.  The trilinear and a5
# samplers read a slab extended by ``hw`` halo planes on each side
# (``parallel/render_dist._with_x_halo``).  Each returns its value with the
# ``owned`` mask.
# ---------------------------------------------------------------------------


def slab_owner_x(x: torch.Tensor, d1: int) -> torch.Tensor:
    """The clamped global voxel x index that decides a sample's slab."""
    return x.clamp(0, d1 - 1)


def octree_nn_index_slab(
    dims: Tuple[int, int, int],
    depth: int,
    p: torch.Tensor,
    x0: int,
    slab_x: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat index into the slab [slab_x, Y, Z], clamped into it; valid;
    owned) of unit-cube points ``p``: :func:`octree_nn_index`'s chain with
    the voxel's x taken relative to the slab."""
    d1, d2, d3 = dims
    ijk, valid = _octree_ijk(dims, depth, p)
    gx = slab_owner_x(ijk[..., 0], d1)
    owned = (gx >= x0) & (gx < x0 + slab_x)
    lx = (gx - x0).clamp(0, slab_x - 1)
    flat = (lx * (d2 * d3) + ijk[..., 1].clamp(0, d2 - 1) * d3
            + ijk[..., 2].clamp(0, d3 - 1))
    return flat, valid, owned


def octree_nn_sample_slab(
    slab_flat: torch.Tensor,
    dims: Tuple[int, int, int],
    depth: int,
    p: torch.Tensor,
    x0: int,
    slab_x: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(intensity, owned): :func:`octree_nn_sample` read from the slab's
    flat values ``slab_flat``, 0 where the slab does not own the sample."""
    flat, valid, owned = octree_nn_index_slab(dims, depth, p, x0, slab_x)
    vals = slab_flat[flat].clamp_min(0.0)
    vals = torch.where(valid & owned, vals,
                       torch.zeros((), dtype=_f32, device=p.device))
    return vals, owned


def corner_intensities_slab(
    ext_flat: torch.Tensor,
    dims: Tuple[int, int, int],
    pos: torch.Tensor,
    x0: int,
    slab_x: int,
    hw: int,
) -> torch.Tensor:
    """:func:`corner_intensities` read from the flat values of the slab
    extended by ``hw`` planes each side.  An owned sample's corners, with
    their row wraps, lie in x rows [x0, x0 + slab_x + 2), so ``hw >= 2``
    reads what the whole volume would; another slab's samples may read
    clamped values, which the caller masks out."""
    d1, d2, d3 = dims
    total = d1 * d2 * d3
    ext_total = (slab_x + 2 * hw) * d2 * d3
    flat = corner_flat_indices(dims, pos)
    lflat = flat - (x0 - hw) * (d2 * d3)
    ok = (flat < total) & (lflat >= 0) & (lflat < ext_total)
    vals = ext_flat[lflat.clamp(0, ext_total - 1)]
    return torch.where(ok, vals, torch.zeros((), dtype=_f32,
                                             device=pos.device))


def trilinear_color_sample_slab(
    ext_flat: torch.Tensor,
    dims: Tuple[int, int, int],
    pos: torch.Tensor,
    classify_fn,
    cal_max: torch.Tensor,
    x0: int,
    slab_x: int,
    hw: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rgba, owned): :func:`trilinear_color_sample` on the extended slab,
    owned by the slab of trunc(x), clamped; 0 where not owned."""
    pos = pos.to(_f32)
    dimv = const(tuple(float(d) for d in dims), pos.device)
    inside = ((pos >= 0.0) & (pos < dimv)).all(dim=-1)
    gx = slab_owner_x(torch.trunc(pos[..., 0]).to(torch.int64), dims[0])
    owned = (gx >= x0) & (gx < x0 + slab_x)
    intens = corner_intensities_slab(ext_flat, dims, pos, x0, slab_x, hw)
    colors8 = classify_fn(intens / cal_max)
    frac = pos - torch.trunc(pos)
    mixed = trilinear_mix_colors(colors8, frac)
    outside_color = classify_fn(torch.zeros_like(cal_max))
    rgba = torch.where(inside[..., None], mixed, outside_color)
    return torch.where(owned[..., None], rgba,
                       torch.zeros((), dtype=_f32, device=pos.device)), owned


def trilinear_intensity_sample_slab(
    ext: torch.Tensor,
    dims: Tuple[int, int, int],
    pos: torch.Tensor,
    x0: int,
    slab_x: int,
    hw: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(value, owned): :func:`trilinear_intensity_sample` on the extended
    slab ``ext`` [slab_x + 2 hw, Y, Z], owned by the slab of the base
    voxel floor(x), clamped; its taps reach floor + 1, so ``hw >= 1``."""
    d1, d2, d3 = dims
    ext_x = slab_x + 2 * hw
    vol = ext.reshape(ext_x * d2 * d3, -1)
    pos = pos.to(_f32)
    base = torch.floor(pos)
    frac = pos - base
    basei = base.to(torch.int32).to(torch.int64)
    gx = slab_owner_x(basei[..., 0], d1)
    owned = (gx >= x0) & (gx < x0 + slab_x)
    zero = torch.zeros((), dtype=_f32, device=pos.device)

    def fetch(ox, oy, oz):
        ix = basei[..., 0] + ox
        iy = basei[..., 1] + oy
        iz = basei[..., 2] + oz
        lx = ix - (x0 - hw)
        ok = ((ix >= 0) & (ix < d1) & (iy >= 0) & (iy < d2) & (iz >= 0)
              & (iz < d3) & (lx >= 0) & (lx < ext_x))
        flat = (lx.clamp(0, ext_x - 1) * (d2 * d3) + iy.clamp(0, d2 - 1) * d3
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
    out = out.squeeze(-1) if out.shape[-1] == 1 else out
    return torch.where(owned, out, zero), owned
