"""The ``Volume``: voxel intensities plus the header values the renderer uses.

The voxel array is C-order ``[X, Y, Z]`` so that the reference's flat index
``x*dim2*dim3 + y*dim3 + z`` (BinaryLoader.cu:234-238) is exactly
``data.reshape(-1)[flat]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Volume:
    """float32 ``data`` [X, Y, Z] (or [X, Y, Z, C]); ``cal_max`` normalizes
    intensities for classification (kernel.cu:64); ``cal_min`` and
    ``pixdim`` are kept from the header; ``dims`` = (X, Y, Z)."""

    data: torch.Tensor
    cal_max: torch.Tensor
    cal_min: torch.Tensor
    pixdim: torch.Tensor
    dims: Tuple[int, int, int]
    channels: int = 1

    @property
    def longest_dimension(self) -> int:
        """max(dim[1..3]) — BinaryLoader.cu:33-36."""
        return max(self.dims)

    @property
    def octree_depth(self) -> int:
        """Smallest d with 2**d >= longest_dimension — Octree.cu:40-41."""
        d = 0
        while 2**d < self.longest_dimension:
            d += 1
        return d

    def to(self, device) -> "Volume":
        return dataclasses.replace(
            self, data=self.data.to(device), cal_max=self.cal_max.to(device),
            cal_min=self.cal_min.to(device), pixdim=self.pixdim.to(device))


def make_volume(
    data,
    cal_max: float = 255.0,
    cal_min: float = 0.0,
    pixdim=(1.0, 1.0, 1.0),
    device=None,
) -> Volume:
    """Build a Volume from an [X, Y, Z] (or [X, Y, Z, C]) array."""
    dev = resolve_device(device)
    arr = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    if arr.ndim not in (3, 4):
        raise ValueError(f"volume must be 3-D or 4-D, got shape {tuple(arr.shape)}")
    dims = tuple(int(s) for s in arr.shape[:3])
    channels = int(arr.shape[3]) if arr.ndim == 4 else 1

    def scalar(v):
        return torch.as_tensor(v, dtype=torch.float32, device=dev)

    return Volume(data=arr, cal_max=scalar(cal_max), cal_min=scalar(cal_min),
                  pixdim=scalar(pixdim), dims=dims, channels=channels)
