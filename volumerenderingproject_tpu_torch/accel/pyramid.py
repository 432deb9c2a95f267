"""Min/max mipmap pyramid: the array form of the reference's octree.

The reference builds a complete pointer-free array octree over [0,1)^3 with
min/max per node for empty-space skipping (Octree.cu:30-156).  Because that
octree is complete, it is information-equivalent to a mipmap stack: level 0
holds the leaf values (the centred nearest-voxel fill of the 2^d grid,
Octree.cu:85-108), and level l is 2x2x2 min/max pooling of level l-1.

The query value semantics live in ``ops/sampling.octree_nn_sample`` (the
octree never changes the output, only the speed); this module supplies the
skip structure and the descent trace of the reference's debugging probe.
Counterpart of ``volumerenderingproject_tpu/accel/pyramid.py``; the
pooling is a reshape and a min or max, which is exact, so every level is
bit-equal on the CPU and the GPU and to ``native.build_pyramid``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ingest.volume import Volume

_f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class MinMaxPyramid:
    """Per-level min/max grids over the 2^depth root cube.

    levels_min/levels_max: tuples of [n_l, n_l, n_l] tensors, level 0
    finest (n_0 = 2^depth), the last level 1x1x1 (the octree root,
    Octree.cu:52).
    """

    levels_min: Tuple[torch.Tensor, ...]
    levels_max: Tuple[torch.Tensor, ...]

    @property
    def depth(self) -> int:
        return len(self.levels_min) - 1

    def root_min(self) -> torch.Tensor:
        return self.levels_min[-1].reshape(())

    def root_max(self) -> torch.Tensor:
        return self.levels_max[-1].reshape(())

    def occupancy(self, level: int) -> torch.Tensor:
        """Boolean grid at ``level``: True where the macro-cell may contain
        content that cannot be skipped (max != min), the early-stop
        complement (Octree.cu:168)."""
        return self.levels_max[level] != self.levels_min[level]


def leaf_grid(volume: Volume) -> torch.Tensor:
    """Level-0 leaf values: the centred nearest-voxel fill of the 2^d cube
    (Octree.cu:85-108), as an [n, n, n] tensor on the volume's device,
    n = 2^depth.

    Cell k holds volume[trunc((k/n*L + dim/2) - L/2)] when the mapped point
    is inside the centred extent, else 0: what
    ``ops/sampling.octree_nn_sample`` computes pointwise.
    """
    dev = volume.data.device
    n = 2**volume.octree_depth
    L = torch.tensor(float(volume.longest_dimension), dtype=_f32, device=dev)
    dims = volume.dims
    two = torch.tensor(2.0, dtype=_f32, device=dev)

    k = torch.arange(n, dtype=_f32, device=dev)
    # k / n is exact (n a power of 2); the product rounds as updateNode's
    res = (k / torch.tensor(float(n), dtype=_f32, device=dev)) * L
    idx, ok = [], []
    for ax in range(3):
        dim = torch.tensor(float(dims[ax]), dtype=_f32, device=dev)
        half_gap = L / two - dim / two
        ok.append((res >= half_gap) & (res < half_gap + dim))
        t = (res + dim / two) - L / two
        idx.append(torch.trunc(t).long().clamp(0, dims[ax] - 1))

    data = volume.data if volume.channels == 1 else volume.data[..., 0]
    grid = data[idx[0][:, None, None], idx[1][None, :, None],
                idx[2][None, None, :]]
    mask = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    grid = torch.where(mask, grid, torch.zeros((), dtype=_f32, device=dev))
    # the octree descent drops negative leaf values (Octree.cu:172-177)
    return grid.clamp_min(0.0)


def _pool2(x: torch.Tensor, reduce) -> torch.Tensor:
    """2x2x2 blocks of [n, n, n] reduced by ``reduce`` (amin or amax) ->
    [n/2, n/2, n/2]."""
    m = x.shape[0] // 2
    return reduce(x.reshape(m, 2, m, 2, m, 2), dim=(1, 3, 5))


def build_pyramid(volume: Volume) -> MinMaxPyramid:
    """Build the full min/max pyramid on the volume's device."""
    leaf = leaf_grid(volume)
    mins, maxs = [leaf], [leaf]
    while mins[-1].shape[0] > 1:
        mins.append(_pool2(mins[-1], torch.amin))
        maxs.append(_pool2(maxs[-1], torch.amax))
    return MinMaxPyramid(levels_min=tuple(mins), levels_max=tuple(maxs))


def occupancy_fraction(pyr: MinMaxPyramid, level: int) -> torch.Tensor:
    """Fraction of level-``level`` macro-cells that cannot be skipped."""
    return pyr.occupancy(level).to(_f32).mean()


def trace_query(pyr: MinMaxPyramid, point, out=print) -> float:
    """Print the octree-descent path for a probe point: the debugging
    equivalent of searchPointGetIntensityPrinted (Octree.cu:186-250,
    invoked from the commented block myApp.cu:849-855).

    Walks from the root down the pyramid levels toward the leaf containing
    ``point``, printing each node's bounds and min/max and stopping early
    where the reference's max==min check would (where the cell is
    homogeneous).  Returns the leaf value (or the homogeneous value).
    """
    p = np.asarray(point, np.float32)
    if not ((p >= 0.0).all() and (p < 1.0).all()):
        out(f"point {p.tolist()} outside the root cube [0,1)^3 -> 0.0")
        return 0.0
    depth = pyr.depth
    for level in range(depth, -1, -1):
        n_l = 2 ** (depth - level)
        cell = np.minimum((p * n_l).astype(np.int64), n_l - 1)
        lo = pyr.levels_min[level][tuple(cell)].item()
        hi = pyr.levels_max[level][tuple(cell)].item()
        size = 1.0 / n_l
        out(
            f"level {depth - level} cell {cell.tolist()} "
            f"corner {(cell * size).tolist()} size {size:g} "
            f"min {float(lo):g} max {float(hi):g}"
        )
        if lo == hi:
            if level == 0:
                out("reached leaf")
            else:
                out("early stop (homogeneous)")
            return float(hi)
    return float(hi)
