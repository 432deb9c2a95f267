"""The device mesh of a sharded render, on ``torch.distributed``.

Counterpart of ``volumerenderingproject_tpu/parallel/mesh.py``: a
("rays", "samples", "volume") mesh over the ranks of a process group.

  * ``rays``: the image's columns are split in blocks; a forward render
    needs no communication until the image is gathered.
  * ``samples``: each ray's samples are split in contiguous segments, whose
    (C, T) pairs compose front to back (``ops/composite.segment_compose``).
  * ``volume``: the voxel grid's x extent is split in slabs; each rank
    composites the samples its slab owns, and the slabs compose in
    visibility order.

A sharded fit differentiates through the gathers: :meth:`Mesh.all_gather`
passes back to each rank the cotangent of its own slice and communicates
nothing, which is exact because every rank of an axis group computes the
same fold, finalize and loss from what it gathered (the sum of the ranks'
own-slice cotangents is the cotangent of the whole).  Each rank's parameter
gradients are then its own units' share, and :meth:`Mesh.all_reduce_` sums
them over the mesh.  (``torch.distributed.nn.functional.all_gather`` would
reduce-scatter the cotangent that every rank holds in full, which
multiplies the gradients by the group's size, and gloo has no
reduce-scatter.)

Rank r sits at the coordinates of JAX's row-major ``reshape(rays, samples,
volume)`` of the device list.  Every rank builds one sub-group per axis of
size > 1 (the ranks that share the other two coordinates), and every rank
calls ``torch.distributed.new_group`` for every group in the same order, as
``new_group`` requires.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("rays", "samples", "volume")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (rays, samples, volume) mesh: the axis sizes
    ``shape``, its coordinates ``coords``, and per axis of size > 1 the
    process group of the ranks along it (in coordinate order)."""

    shape: Tuple[int, int, int]
    coords: Tuple[int, int, int]
    groups: Dict[str, object]

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def coord(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def all_gather(self, tensor: torch.Tensor, axis: str
                   ) -> List[torch.Tensor]:
        """``tensor`` of every rank along ``axis``, in coordinate order,
        differentiable: the backward gives this rank the cotangent of its
        own slice (the module docstring says why that is exact)."""
        if self.size(axis) == 1:
            return [tensor]
        return list(_AllGather.apply(tensor, self, axis))

    def _gather(self, tensor: torch.Tensor, axis: str
                ) -> List[torch.Tensor]:
        """The communication of :meth:`all_gather`.  The gloo backend
        gathers CPU tensors only, so under it a CUDA tensor goes to the
        host and back; only the gather moves."""
        group = self.groups[axis]
        src = tensor.contiguous()
        host = dist.get_backend(group) == "gloo" and src.is_cuda
        if host:
            src = src.cpu()
        out = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(out, src, group=group)
        if host:
            out = [t.to(tensor.device) for t in out]
        return out

    def all_reduce_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` over the whole mesh, in place: along each axis of
        size > 1 in turn (rays, samples, volume), which the per-axis groups
        give with no group of their own.  Under gloo a CUDA tensor goes
        through the host, as in :meth:`all_gather`.  -> ``tensor``."""
        for axis in AXES:
            if self.size(axis) == 1:
                continue
            group = self.groups[axis]
            host = dist.get_backend(group) == "gloo" and tensor.is_cuda
            buf = tensor.detach().cpu() if host else tensor.detach()
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            if host:
                with torch.no_grad():
                    tensor.copy_(buf)
        return tensor


class _AllGather(torch.autograd.Function):
    """tensor -> the tensors of every rank along an axis; the backward
    returns the cotangent of this rank's own slice and communicates
    nothing."""

    @staticmethod
    def forward(ctx, tensor: torch.Tensor, mesh: Mesh, axis: str):
        ctx.own = mesh.coord(axis)
        return tuple(mesh._gather(tensor.detach(), axis))

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        return grads[ctx.own], None, None


def coords_of(rank: int, shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Coordinates of ``rank`` in the row-major (rays, samples, volume)
    grid."""
    _, s, v = shape
    return rank // (s * v), (rank // v) % s, rank % v


def make_mesh(rays: Optional[int] = None, samples: int = 1, volume: int = 1,
              group=None) -> Mesh:
    """The ("rays", "samples", "volume") mesh over the ranks of ``group``
    (the default group unless given); ``rays`` defaults to what remains
    after ``samples * volume``.  The group's size must equal rays * samples
    * volume.  Every rank of the group calls this with the same sizes."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "initialize_distributed (or parallel/launch.spawn)"
                           " first")
    world = dist.get_world_size(group)
    if rays is None:
        if world % (samples * volume):
            raise ValueError(f"{world} ranks not divisible by "
                             f"{samples * volume}")
        rays = world // (samples * volume)
    shape = (rays, samples, volume)
    if rays * samples * volume != world:
        raise ValueError(f"mesh {shape} needs {rays * samples * volume} "
                         f"ranks, the group has {world}")
    global_rank = (list(range(world)) if group is None else
                   [dist.get_global_rank(group, r) for r in range(world)])
    coords = coords_of(dist.get_rank(group), shape)
    groups = {}
    for a, axis in enumerate(AXES):
        if shape[a] == 1:
            continue
        # one group per line of the mesh along this axis, all of them built
        # on every rank in the same order
        for r in range(world):
            c = coords_of(r, shape)
            if c[a] != 0:
                continue
            line = []
            for k in range(shape[a]):
                ck = list(c)
                ck[a] = k
                line.append(global_rank[(ck[0] * samples + ck[1]) * volume
                                        + ck[2]])
            g = dist.new_group(ranks=line)
            if all(c[b] == coords[b] for b in range(3) if b != a):
                groups[axis] = g
    return Mesh(shape=shape, coords=coords, groups=groups)


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group`` passthrough; pass the
    backend, an ``init_method`` or a ``store``, ``world_size`` and
    ``rank``."""
    dist.init_process_group(**kwargs)
