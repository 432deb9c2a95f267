"""Sharded rendering over a ("rays", "samples", "volume") mesh, and its
differentiable form for sharded fits.

Counterpart of ``volumerenderingproject_tpu/parallel/render_dist.py``
(``render_vrc_sharded``, render_dist.py:257-668), with ``torch.distributed``
in place of ``shard_map``:

  * ``rays``: each rank renders the columns [ri * w, (ri + 1) * w) of the
    image, w = width / rays, with rays on their global columns;
  * ``samples``: each rank marches the samples [si * s, (si + 1) * s) of
    its rays, s = samples_per_ray / samples, into a front-to-back (C, T)
    pair; the pairs are gathered along the axis and folded front to back
    with the associative over operator (``ops/composite.segment_compose``);
  * ``volume``: each rank keeps the x-slab [vi * X/volume, (vi + 1) *
    X/volume) of the voxel grid and composites only the samples it owns;
    the slabs' pairs are gathered along the axis and folded in slab order,
    reversed when ``camera.front.x < 0``.  A conic ray's x is monotone
    along it, so each slab's samples form one run of the ray; the fold is
    taken in both orders and each conic ray picks the one its own
    direction gives (render_dist.py:623-650).

Then :func:`ops.composite.segment_finalize` puts the background in, and the
columns are gathered along "rays": every rank returns the full [W, H, 4]
image.

Each rank's work unit is a hand-written kernel run at its offsets, as the
JAX package routes it (``_pallas_segment_eligible``, render_dist.py:65-161):

  * a1 on the rays and samples axes: K1's segment mode
    (``ops/march.render_vrc_fused``, ``segment=True``) in all its
    variants, plain, LUT, baked (lit or scattered; the bake runs on the
    whole volume on every rank), LUT + baked, in-kernel lit and 4-D
    channel grids;
  * a1 on the volume axis: K1's slab mode, plain, LUT and channel grids;
  * a5 on the rays and samples axes: K3's segment mode
    (``ops/a5.render_test_fused``, ``segment=True``), unlit and baked.

On CPU tensors the kernels' plain versions run instead.  What no segment
kernel computes raises: on the rays and samples axes smooth mode
(``Interp.TRILINEAR``) and an explicit ``light`` render through the plain
scan segments (``models/raycast.render_vrc_segment``,
``render_test_segment``) under ``mode="scan"`` only; on the volume axis
lighting, scattering, smooth mode and a5 need the JAX package's slab scan
with x-halos (render_dist.py:563-580), ROADMAP.md item 14b.2.

``differentiable=True`` (a sharded fit, diff/fit.py's mesh path) runs each
rank's work unit through the autograd functions of the differentiable
marches, as the JAX package routes it (``_diff_segment_eligible``,
render_dist.py:189-254, and its fused diff cores, :387-466): forward K1
and backward K4 (``ops/march_vjp.render_vrc_diff``), or K3 and K6
(``ops/a5_vjp.render_test_diff``), at the unit's offsets, eps 0:

  * a1 nearest-voxel, one channel, no LUT, no scattering, at most 16
    intervals: on the rays and samples axes plain, baked (``lighting``)
    and with an explicit ``light`` on ortho rays, whose 10 parameters
    train through tangent marches of K1 baked; on the volume axis plain
    (ortho or conic) and baked with the default light (ortho), the bake the
    whole volume's, cropped to the slab;
  * a5 unlit on the rays and samples axes.

The fold differentiates through ``Mesh.all_gather`` (each rank takes the
cotangent of its own slice).  The other sharded fits raise: LUT, 4-D,
smooth, scattered, more than 16 intervals and conic lit ones, which the
JAX package differentiates through its XLA scan segments (ROADMAP.md item
11a), and a light on the volume axis or a5 slabs (its slab scan, item
14b.2).  The TPU's memory predicates (``packed_geometry``,
``baked_light_feasible``) have no counterpart: the volume stays in device
memory.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..models import raycast
from ..ops import a5, a5_vjp, march, march_vjp
from ..ops import composite as comp
from ..ops.phong import Light
from ..utils.config import Algorithm, Interp, RenderConfig
from .mesh import Mesh

_f32 = torch.float32


def shard_sizes(volume, config: RenderConfig, shape: Tuple[int, int, int]
                ) -> Tuple[int, int, int]:
    """(columns, samples, slab planes) of one work unit on a mesh of
    ``shape``, after the JAX package's checks (render_dist.py:298-325);
    slab planes 0 without a volume axis."""
    n_rays, n_samp, n_vol = shape
    if config.width % n_rays:
        raise ValueError(f"width {config.width} % rays axis {n_rays} != 0")
    if config.samples_per_ray % n_samp:
        raise ValueError(
            f"spr {config.samples_per_ray} % samples axis {n_samp} != 0")
    if volume.dims[0] % n_vol:
        raise ValueError(f"dim x {volume.dims[0]} % volume axis {n_vol} != 0")
    if n_vol > 1 and volume.channels > 1 and (
            config.algorithm is not Algorithm.VRC
            or config.interp is not Interp.NEAREST):
        raise NotImplementedError(
            "volume-axis sharding of multi-channel volumes supports the "
            "nearest-neighbor a1 path (the only multi-channel sampler)")
    if n_vol > 1 and config.scattering and (
            config.interp is not Interp.NEAREST or volume.channels != 1):
        raise NotImplementedError(
            "volume-sharded scattering is the single-channel a1 NN path "
            "(the sharded light-transmittance sweep); use rays/samples axes")
    return (config.width // n_rays, config.samples_per_ray // n_samp,
            volume.dims[0] // n_vol if n_vol > 1 else 0)


def _check_route(config: RenderConfig, mode: str, slab: bool,
                 light: Light | None) -> None:
    """Raise for a work unit that no segment kernel computes, naming
    ``mode="scan"`` (rays and samples axes) or ROADMAP.md item 14b.2 (the
    volume axis)."""
    if mode not in ("fast", "scan"):
        raise ValueError(f"unknown mode {mode!r}: a sharded render takes "
                         "'fast' or 'scan'")
    test = config.algorithm is Algorithm.TEST
    if slab:
        if (mode == "scan" or test or light is not None or config.lighting
                or config.scattering or config.interp is not Interp.NEAREST):
            raise NotImplementedError(
                "this volume-axis render (the slab scan with x-halos: "
                "lighting, scattering, smooth mode, a5, an explicit light, "
                "mode='scan') is not ported yet: ROADMAP.md item 14b.2")
        return
    if mode == "fast" and (light is not None or (
            not test and config.interp is Interp.TRILINEAR)):
        raise NotImplementedError(
            "no segment kernel renders smooth mode (Interp.TRILINEAR) or an "
            "explicit light on the rays and samples axes, as in the JAX "
            "package (render_dist.py:376-381); mode='scan' renders them "
            "through the plain scan segments")


def check_diff_route(volume, tf, config: RenderConfig, mode: str,
                     slab: bool, light: Light | None) -> None:
    """Raise NotImplementedError for a sharded fit's work unit that no
    differentiable kernel computes (the module docstring), naming ROADMAP.md
    item 11a (the JAX package's XLA scan segments) or 14b.2 (its slab
    scan)."""
    if mode != "fast":
        raise NotImplementedError(
            "a sharded fit runs the differentiable kernels (mode='fast'); "
            "fits through the scan segments are ROADMAP.md item 11a")
    test = config.algorithm is Algorithm.TEST
    what = None
    if volume.channels != 1:
        what = "fits of 4-D volumes"
    elif not test and config.interp is not Interp.NEAREST:
        what = "smooth fits"
    elif config.scattering:
        what = "scattered fits"
    elif config.tf_lut:
        what = "LUT fits"
    elif tf.num_intervals > march_vjp.MAX_INTERVALS:
        what = (f"fits of more than {march_vjp.MAX_INTERVALS} intervals "
                f"({tf.num_intervals})")
    elif config.conic and (config.lighting or light is not None):
        what = "conic lit fits"
    elif test and (config.lighting or light is not None):
        what = "lit a5 fits"
    if what is not None:
        raise NotImplementedError(
            f"sharded {what} are not ported yet: ROADMAP.md item 11a (the "
            "scan route for fits; the JAX package differentiates them "
            "through its XLA scan segments, render_dist.py:189-254)")
    if slab and (test or light is not None):
        raise NotImplementedError(
            "a sharded fit on the volume axis with an explicit light or a5 "
            "is not ported yet: ROADMAP.md item 14b.2 (the JAX package "
            "differentiates it through its slab scan)")


def render_segment(volume, tf, camera, config: RenderConfig,
                   shape: Tuple[int, int, int], coords: Tuple[int, int, int],
                   *, mode: str = "fast", light: Light | None = None,
                   differentiable: bool = False):
    """The work unit of the rank at ``coords`` of a ``shape`` mesh -> its
    (C [w, H, 3], T [w, H, 1]) pair.  ``volume`` is the whole volume, of
    which a volume-axis unit keeps its slab's planes.  ``mode="fast"`` runs
    the segment kernels (their plain versions on CPU tensors) at
    ``config.early_termination``; ``mode="scan"`` the plain scan segments,
    rays and samples axes only.  ``differentiable=True`` runs the
    differentiable kernels at eps 0, the pair differentiable with respect to
    ``tf.colors`` (and ``light``'s fields)."""
    w_local, s_local, slab_x = shard_sizes(volume, config, shape)
    ri, si, vi = coords
    unit = dict(x_offset=ri * w_local, local_width=w_local,
                s_start=si * s_local, s_count=s_local)
    test = config.algorithm is Algorithm.TEST
    if differentiable:
        check_diff_route(volume, tf, config, mode, slab_x > 0, light)
        if test:
            return a5_vjp.render_test_diff(volume, tf, camera, config,
                                           device=volume.data.device,
                                           segment=True, **unit)
        if slab_x:
            unit.update(x0=vi * slab_x, slab_x=slab_x)
        return march_vjp.render_vrc_diff(volume, tf, camera, config,
                                         device=volume.data.device,
                                         light=light, segment=True, **unit)
    _check_route(config, mode, slab_x > 0, light)
    if mode == "scan":
        scan = raycast.render_test_segment if test else (
            raycast.render_vrc_segment)
        return scan(volume, tf, camera, config, light=light, **unit)
    if test:
        return a5.render_test_fused(volume, tf, camera, config, segment=True,
                                    **unit)
    if slab_x:
        unit.update(x0=vi * slab_x, slab_x=slab_x)
    return march.render_vrc_fused(volume, tf, camera, config, segment=True,
                                  **unit)


def fold_volume(segs_c: List[torch.Tensor], segs_t: List[torch.Tensor],
                camera, config: RenderConfig, x_offset: int,
                local_width: int):
    """Fold the slabs' (C, T) pairs of one work unit's rays in visibility
    order: slab 0 first when ``camera.front.x >= 0``; conic a1 rays each by
    the sign of their own direction's x (a5 marches along the front for
    every ray, so its fold follows the front)."""
    if config.conic and config.algorithm is not Algorithm.TEST:
        dirs = raycast.primary_ray_dirs(camera, config, x_offset,
                                        local_width)
        return comp.fold_segments(segs_c, segs_t,
                                  (dirs[..., 0] < 0.0)[..., None])
    return comp.fold_segments(segs_c, segs_t, bool(camera.front[0] < 0.0))


def render_vrc_sharded(volume, tf, camera, config: RenderConfig, mesh: Mesh,
                       *, mode: str = "fast", light: Light | None = None,
                       differentiable: bool = False) -> torch.Tensor:
    """Distributed a1/VRC or a5/TEST render over ``mesh`` -> the full
    [W, H, 4] image (alpha 1) on every rank.

    Every rank passes the same ``volume`` (the whole volume; a volume-axis
    rank keeps its slab), TF, camera and config, on its own device.  The
    work unit of each rank and what raises are as the module docstring
    says; ``mode="scan"`` runs the plain scan segments on the rays and
    samples axes.  The gathers run on the mesh's groups: NCCL on CUDA
    tensors, gloo on CPU tensors (or on CUDA tensors through the host).
    ``differentiable=True`` renders at eps 0 through the differentiable
    kernels, the image differentiable with respect to ``tf.colors`` (and
    ``light``'s fields on the rays and samples axes); each rank's gradients
    are then its own units' share, which ``Mesh.all_reduce_`` sums.
    """
    shape = mesh.shape
    w_local = config.width // shape[0]
    c, t = render_segment(volume, tf, camera, config, shape, mesh.coords,
                          mode=mode, light=light,
                          differentiable=differentiable)
    if mesh.size("volume") > 1:
        c, t = fold_volume(mesh.all_gather(c, "volume"),
                           mesh.all_gather(t, "volume"), camera, config,
                           mesh.coord("rays") * w_local, w_local)
    c, t = comp.fold_segments(mesh.all_gather(c, "samples"),
                              mesh.all_gather(t, "samples"))
    cols = comp.segment_finalize(
        (c, t), torch.tensor(config.background, dtype=_f32, device=c.device))
    return torch.cat(mesh.all_gather(cols, "rays"), dim=0)
