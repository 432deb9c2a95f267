"""The a1 sampler: the value semantics of the reference's min/max octree
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
