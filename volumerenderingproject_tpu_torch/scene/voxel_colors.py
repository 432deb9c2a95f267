"""Voxel-cloud colouring schemes from the reference app (myApp.cu), for
the point cloud's CPU voxel-colour pass (volumePrepareForPipeline /
prepareVolumeColors, myApp.cu:1254-1316):

  * :func:`tf_colors`         — prepareVolumeColors: TF colour per voxel
    (the scheme the app uses).
  * :func:`intensity_bands`   — niftiColorTest (myApp.cu:1319-1338):
    hardcoded intensity-band colours.
  * :func:`intensity_green`   — niftiColorTest2 (myApp.cu:1341-1360):
    green-scaled intensity with coloured axis planes.

Each returns [X, Y, Z, 4] RGBA on the volume's device, vectorized over the
whole volume (the reference loops per voxel on the host at start-up);
``reshape(-1, 4)`` gives ``render_points``' ``rgba=``.  4-D volumes colour
their channel 0.
"""

from __future__ import annotations

import torch

from ..ingest.volume import Volume
from ..utils.device import const
from .transfer_function import TransferFunction

_f32 = torch.float32


def _intensity(volume: Volume) -> torch.Tensor:
    data = volume.data if volume.channels == 1 else volume.data[..., 0]
    return data / volume.cal_max


def tf_colors(volume: Volume, tf: TransferFunction) -> torch.Tensor:
    """[X, Y, Z, 4] RGBA per voxel through the transfer function
    (prepareVolumeColors myApp.cu:1306-1312)."""
    return tf.classify(_intensity(volume))


def intensity_bands(volume: Volume) -> torch.Tensor:
    """niftiColorTest's hardcoded bands (myApp.cu:1325-1336); intensities
    outside every band are transparent black."""
    v = _intensity(volume)
    dev = v.device
    bands = [
        (0.1, 0.3, (0.1, 0.1, 0.1, 1.0)),
        (0.3, 0.4, (0.0, 0.0, 0.8, 1.0)),
        (0.4, 0.5, (0.8, 0.8, 0.4, 1.0)),
        (0.5, 0.6, (0.1, 0.5, 0.5, 1.0)),
        (0.6, 0.7, (0.5, 0.5, 0.5, 1.0)),
    ]
    out = torch.zeros(v.shape + (4,), dtype=_f32, device=dev)
    for lo, hi, c in bands:
        match = (v >= lo) & (v < hi)
        out = torch.where(match[..., None], const(c, dev), out)
    # the last band is inclusive at both ends (myApp.cu:1335)
    match = (v >= 0.7) & (v <= 1.0)
    return torch.where(match[..., None], const((0.9, 0.5, 0.5, 1.0), dev),
                       out)


def intensity_green(volume: Volume) -> torch.Tensor:
    """niftiColorTest2 (myApp.cu:1341-1360): green = intensity * 255 (the
    reference's unclamped quirk kept), the axis-zero planes painted
    magenta/yellow/cyan; the reference's later ifs win, so z == 0 wins
    over y == 0 over x == 0."""
    v = _intensity(volume)
    dev = v.device
    zero = torch.zeros_like(v)
    green = torch.stack([zero, v * 255.0, zero, torch.ones_like(v)], dim=-1)
    out = torch.where((v > 0.0)[..., None], green,
                      torch.zeros((), dtype=_f32, device=dev))
    x, y, z = torch.meshgrid(*(torch.arange(d, device=dev)
                               for d in v.shape), indexing="ij")
    for axis, c in ((x, (1.0, 0.0, 1.0, 1.0)), (y, (1.0, 1.0, 0.0, 1.0)),
                    (z, (0.0, 1.0, 1.0, 1.0))):
        out = torch.where((axis == 0)[..., None], const(c, dev), out)
    return out
