"""Debug voxel colourers for the point cloud (``Algorithm.POINT``).

Vectorized ports of the reference's development fixtures
(myApp.cu:1319-1398): intensity-band false colour (`niftiColorTest`),
intensity-green with axis-plane markers (`niftiColorTest2`, the one marked
"IN USE"), and the octant-coloured sphere (`sphereTest`).  Each returns a
per-voxel RGBA tensor [N, 4] on the volume's device, to pass to
``models.point_splat.render_points(..., rgba=...)`` in place of the
transfer function's colours.  4-D volumes colour their channel 0.
"""

from __future__ import annotations

import torch

from ..ingest.volume import Volume
from ..utils.device import const

_f32 = torch.float32


def _grids(volume: Volume):
    """The flat x, y, z voxel indices [N] (int64)."""
    d1, d2, d3 = volume.dims
    dev = volume.data.device
    x, y, z = torch.meshgrid(*(torch.arange(d, device=dev)
                               for d in (d1, d2, d3)), indexing="ij")
    return x.reshape(-1), y.reshape(-1), z.reshape(-1)


def _intensity(volume: Volume) -> torch.Tensor:
    v = volume.data if volume.channels == 1 else volume.data[..., 0]
    return v.reshape(-1) / volume.cal_max


def nifti_color_test(volume: Volume) -> torch.Tensor:
    """Intensity-band false colour (myApp.cu:1319-1338): six hand-picked
    bands over intensity/cal_max, transparent black elsewhere."""
    inten = _intensity(volume)
    dev = inten.device
    bands = [  # (lo, hi, rgba); hi exclusive except the last (<= 1.0)
        (0.1, 0.3, (0.1, 0.1, 0.1, 1.0)),
        (0.3, 0.4, (0.0, 0.0, 0.8, 1.0)),
        (0.4, 0.5, (0.8, 0.8, 0.4, 1.0)),
        (0.5, 0.6, (0.1, 0.5, 0.5, 1.0)),
        (0.6, 0.7, (0.5, 0.5, 0.5, 1.0)),
    ]
    rgba = torch.zeros((inten.shape[0], 4), dtype=_f32, device=dev)
    for lo, hi, c in bands:
        m = (inten >= lo) & (inten < hi)
        rgba = torch.where(m[:, None], const(c, dev), rgba)
    m = (inten >= 0.7) & (inten <= 1.0)
    return torch.where(m[:, None], const((0.9, 0.5, 0.5, 1.0), dev), rgba)


def nifti_color_test2(volume: Volume) -> torch.Tensor:
    """Green-by-intensity with magenta/yellow/cyan x=0/y=0/z=0 planes
    (myApp.cu:1341-1360, marked IN USE upstream); the reference's
    ``intensity * 255`` overflows [0, 1] and GL clamps it, so it is
    clipped here."""
    inten = _intensity(volume)
    dev = inten.device
    x, y, z = _grids(volume)
    rgba = torch.zeros((inten.shape[0], 4), dtype=_f32, device=dev)
    g = (inten * 255.0).clamp(0.0, 1.0)
    zero = torch.zeros_like(g)
    rgba = torch.where((inten > 0.0)[:, None],
                       torch.stack([zero, g, zero, torch.ones_like(g)], -1),
                       rgba)
    for axis, c in ((x, (1.0, 0.0, 1.0, 1.0)), (y, (1.0, 1.0, 0.0, 1.0)),
                    (z, (0.0, 1.0, 1.0, 1.0))):
        rgba = torch.where((axis == 0)[:, None], const(c, dev), rgba)
    return rgba


def sphere_octants(volume: Volume, background=(0.2, 0.2, 0.2)
                   ) -> torch.Tensor:
    """Octant-coloured inscribed sphere with inverted-background end caps
    (sphereTest myApp.cu:1363-1398)."""
    d1, d2, d3 = volume.dims
    dev = volume.data.device
    x, y, z = _grids(volume)
    cx, cy, cz = d1 / 2.0, d2 / 2.0, d3 / 2.0
    r2 = (d1 / 2.0) ** 2
    xf, yf, zf = x.to(_f32), y.to(_f32), z.to(_f32)
    inside = (xf - cx) ** 2 + (yf - cy) ** 2 + (zf - cz) ** 2 <= r2
    octant_colors = torch.tensor([
        (0.0, 0.0, 0.0, 1.0),  # x<=,y<=,z<=
        (1.0, 1.0, 1.0, 1.0),  # x<=,y<=,z>
        (0.0, 1.0, 1.0, 1.0),  # x<=,y>,z<=
        (1.0, 0.0, 1.0, 1.0),  # x<=,y>,z>
        (1.0, 1.0, 0.0, 1.0),  # x>,y<=,z<=
        (0.0, 0.0, 1.0, 1.0),  # x>,y<=,z>
        (0.0, 1.0, 0.0, 1.0),  # x>,y>,z<=
        (1.0, 0.0, 0.0, 1.0),  # x>,y>,z>
    ], dtype=_f32, device=dev)
    oct_id = ((xf > cx).long() * 4 + (yf > cy).long() * 2
              + (zf > cz).long())
    rgba = torch.where(inside[:, None], octant_colors[oct_id],
                       torch.zeros((), dtype=_f32, device=dev))
    bg = [float(b) for b in background[:3]]
    cap = torch.tensor([1.0 - bg[0], 1.0 - bg[1], 1.0 - bg[2], 1.0],
                       dtype=_f32, device=dev)
    caps = (z == 0) | (z == d3 - 1)
    return torch.where(caps[:, None], cap, rgba)
