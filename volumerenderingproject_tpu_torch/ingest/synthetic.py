"""Synthetic analytic volumes, the reference's test fixtures.

  * :func:`centered_sphere` — BinaryLoader.cu:338-367 ``loadSphereToMem``:
    radius n/2 about the grid center, intensity = y/n·255.
  * :func:`corner_sphere` — BinaryLoader.cu:369-398
    ``loadZEROCornerSphereToMem``: radius n about the (0,0,0) corner,
    intensity = (r/R)²·255.
  * :func:`rgb_sphere` — the JAX package's 4-D fixture (synthetic.py:44-56):
    a centered sphere whose three channels encode x, y, z.
  * :func:`octant_sphere_colors` — sphereTest (myApp.cu:1363-1398): an
    RGBA grid, octant-coloured, for the point cloud's ``rgba=``.

Both are built in numpy, in float64 then rounded to float32, and only then
moved to the device, so every device gets the same voxels.
"""

from __future__ import annotations

import numpy as np

from .volume import Volume, make_volume


def centered_sphere(n: int = 100, cal_max: float = 255.0,
                    device=None) -> Volume:
    """Sphere of radius n/2 about the grid center; intensity = y/n * 255."""
    coords = np.arange(n, dtype=np.float64)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    c = n / 2.0
    inside = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 <= (n / 2.0) ** 2
    vals = (y / float(n) * 255.0).astype(np.float32)
    data = np.where(inside, vals, np.float32(0.0)).astype(np.float32)
    return make_volume(data, cal_max=cal_max, device=device)


def corner_sphere(n: int = 100, cal_max: float = 255.0,
                  device=None) -> Volume:
    """Sphere of radius n about (0,0,0); intensity = (r/R)^2 * 255."""
    coords = np.arange(n, dtype=np.float64)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    r2 = x**2 + y**2 + z**2
    inside = r2 <= float(n) ** 2
    vals = (r2 / float(n) ** 2 * 255.0).astype(np.float32)
    data = np.where(inside, vals, np.float32(0.0)).astype(np.float32)
    return make_volume(data, cal_max=cal_max, device=device)


def rgb_sphere(n: int = 64, cal_max: float = 255.0, device=None) -> Volume:
    """4-D multichannel fixture [n, n, n, 3]: a sphere of radius n/2 about
    the grid center whose channels are x/n, y/n, z/n * 255 inside it, 0
    outside."""
    coords = np.arange(n, dtype=np.float64)
    x, y, z = np.meshgrid(coords, coords, coords, indexing="ij")
    c = n / 2.0
    inside = (x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2 <= (n / 2.0) ** 2
    chans = np.stack([x / n * 255.0, y / n * 255.0, z / n * 255.0],
                     axis=-1).astype(np.float32)
    data = np.where(inside[..., None], chans, np.float32(0.0))
    return make_volume(data, cal_max=cal_max, device=device)


def octant_sphere_colors(dims=(100, 100, 100),
                         background=(0.2, 0.2, 0.2)) -> np.ndarray:
    """Octant-colored sphere RGBA grid (myApp.cu:1363-1398), a numpy array
    [X, Y, Z, 4]: inside the sphere of radius X/2 about the grid centre the
    colour of the voxel's octant, transparent black outside, and the z = 0
    and z = Z - 1 planes the background's complement (myApp.cu:1394-1395)."""
    dx, dy, dz = dims
    coords = [np.arange(d, dtype=np.float64) for d in dims]
    x, y, z = np.meshgrid(*coords, indexing="ij")
    cx, cy, cz = dx / 2.0, dy / 2.0, dz / 2.0
    inside = (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= (dx / 2.0) ** 2
    octant_colors = np.array([
        # (x>cx, y>cy, z>cz) ordered as binary xyz
        [0.0, 0.0, 0.0, 1.0],  # 000
        [1.0, 1.0, 1.0, 1.0],  # 001
        [0.0, 1.0, 1.0, 1.0],  # 010
        [1.0, 0.0, 1.0, 1.0],  # 011
        [1.0, 1.0, 0.0, 1.0],  # 100
        [0.0, 0.0, 1.0, 1.0],  # 101
        [0.0, 1.0, 0.0, 1.0],  # 110
        [1.0, 0.0, 0.0, 1.0],  # 111
    ], dtype=np.float32)
    idx = ((x > cx).astype(int) * 4 + (y > cy).astype(int) * 2
           + (z > cz).astype(int))
    rgba = np.where(inside[..., None], octant_colors[idx], np.float32(0.0))
    edge = (z == 0) | (z == dz - 1)
    bg = np.asarray([1.0 - background[0], 1.0 - background[1],
                     1.0 - background[2], 1.0], np.float32)
    rgba = np.where(edge[..., None], bg, rgba)
    return rgba.astype(np.float32)
