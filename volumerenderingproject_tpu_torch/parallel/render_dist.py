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

On CPU tensors the kernels' plain versions run instead.  ``mode="scan"``
runs the scans instead of the kernels (render_dist.py:583-625): on the rays
and samples axes the plain scan segments
(``models/raycast.render_vrc_segment``, ``render_test_segment``), on the
volume axis the slab scan (:func:`render_segment_volume_slab`,
render_dist.py:736), which marches each unit's rays against its x-slab
with x-halos, the samples of other slabs the over identity.  What no
segment kernel computes raises in ``mode="fast"``, naming ``mode='scan'``:
smooth mode (``Interp.TRILINEAR``, ``TRILINEAR_COLOR``) and an explicit
``light`` on the rays and samples axes, and lighting, scattering, smooth
mode, a5 and an explicit light on the volume axis.

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
cotangent of its own slice).  The other sharded fits raise in
``mode="fast"``, naming ``mode='scan'``: LUT, 4-D, smooth, scattered, more
than 16 intervals, conic lit and lit a5 ones, which the JAX package
differentiates through its XLA scan segments, and a light on the volume
axis or a5 slabs (its slab scan).  ``differentiable=True`` with
``mode="scan"`` runs the scan segments and the slab scan under autograd,
checkpointed in chunks of samples (``models/raycast.SCAN_CHUNK``), for
every config.  The TPU's memory predicates (``packed_geometry``,
``baked_light_feasible``) have no counterpart: the volume stays in device
memory.

The JAX slab scan ignores ``config.tf_lut``; the port's applies it, as
its LUT slab kernels and every single-device path do, and it scatters a5
slabs, which the JAX slab scan leaves unscattered: the folded slabs equal
the single-device render in every config.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..models import raycast
from ..ops import a5, a5_vjp, conv3d, march, march_vjp, phong, sampling
from ..ops import composite as comp
from ..ops.phong import Light
from ..scene.transfer_function import take_rows
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
            "nearest-neighbor a1 path (the only multi-channel sampler), as "
            "in the JAX package; the rays and samples axes render the rest "
            "(mode='scan')")
    if n_vol > 1 and config.scattering and (
            config.interp is not Interp.NEAREST or volume.channels != 1):
        raise NotImplementedError(
            "volume-sharded scattering is the single-channel a1 NN path "
            "(the sharded light-transmittance sweep); use rays/samples axes")
    return (config.width // n_rays, config.samples_per_ray // n_samp,
            volume.dims[0] // n_vol if n_vol > 1 else 0)


def _check_mode(mode: str) -> None:
    if mode not in ("fast", "scan"):
        raise ValueError(f"unknown mode {mode!r}: a sharded render takes "
                         "'fast' or 'scan'")


def _check_route(config: RenderConfig, mode: str, slab: bool,
                 light: Light | None) -> None:
    """Raise, naming ``mode='scan'``, for a work unit that no segment
    kernel computes in ``mode="fast"``."""
    _check_mode(mode)
    if mode == "scan":
        return
    test = config.algorithm is Algorithm.TEST
    if slab:
        if (test or light is not None or config.lighting
                or config.scattering or config.interp is not Interp.NEAREST):
            raise NotImplementedError(
                "no slab kernel renders lighting, scattering, smooth mode, "
                "Interp.TRILINEAR_COLOR, a5 or an explicit light on the "
                "volume axis, as in the JAX package (render_dist.py:563-580); "
                "mode='scan' renders them through the slab scan with x-halos")
        return
    if light is not None or (not test
                             and config.interp is not Interp.NEAREST):
        raise NotImplementedError(
            "no segment kernel renders smooth mode (Interp.TRILINEAR, "
            "TRILINEAR_COLOR) or an explicit light on the rays and samples "
            "axes, as in the JAX package (render_dist.py:376-381); "
            "mode='scan' renders them through the plain scan segments")


def check_diff_route(volume, tf, config: RenderConfig, mode: str,
                     slab: bool, light: Light | None) -> None:
    """Raise NotImplementedError, naming ``mode='scan'``, for a sharded
    fit's work unit that no differentiable kernel computes in
    ``mode="fast"`` (the module docstring); ``mode="scan"`` fits every
    config (the JAX package's XLA scan segments and slab scan)."""
    _check_mode(mode)
    if mode == "scan":
        return
    test = config.algorithm is Algorithm.TEST
    what = None
    if volume.channels != 1:
        what = "fits of 4-D volumes"
    elif not test and config.interp is Interp.TRILINEAR:
        what = "smooth fits"
    elif not test and config.interp is Interp.TRILINEAR_COLOR:
        what = "Interp.TRILINEAR_COLOR fits"
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
            f"no differentiable work unit computes sharded {what} (the JAX "
            "package differentiates them through its XLA scan segments, "
            "render_dist.py:189-254): mode='scan' fits them")
    if slab and (test or light is not None):
        raise NotImplementedError(
            "no differentiable slab unit takes an explicit light or a5 (the "
            "JAX package differentiates them through its slab scan): "
            "mode='scan' fits them")


def render_segment(volume, tf, camera, config: RenderConfig,
                   shape: Tuple[int, int, int], coords: Tuple[int, int, int],
                   *, mode: str = "fast", light: Light | None = None,
                   differentiable: bool = False):
    """The work unit of the rank at ``coords`` of a ``shape`` mesh -> its
    (C [w, H, 3], T [w, H, 1]) pair.  ``volume`` is the whole volume, of
    which a volume-axis unit keeps its slab's planes.  ``mode="fast"`` runs
    the segment kernels (their plain versions on CPU tensors) at
    ``config.early_termination``; ``mode="scan"`` the plain scan segments,
    or on the volume axis the slab scan.  ``differentiable=True`` runs the
    differentiable kernels at eps 0, the pair differentiable with respect to
    ``tf.colors`` (and ``light``'s fields); with ``mode="scan"`` the scans
    under autograd, differentiable with respect to every parameter."""
    w_local, s_local, slab_x = shard_sizes(volume, config, shape)
    ri, si, vi = coords
    unit = dict(x_offset=ri * w_local, local_width=w_local,
                s_start=si * s_local, s_count=s_local)
    test = config.algorithm is Algorithm.TEST
    if differentiable:
        check_diff_route(volume, tf, config, mode, slab_x > 0, light)
    else:
        _check_route(config, mode, slab_x > 0, light)
    if mode == "scan":
        if slab_x:
            return render_segment_volume_slab(
                volume, tf, camera, config, x0=vi * slab_x, slab_x=slab_x,
                light=light, **unit)
        scan = raycast.render_test_segment if test else (
            raycast.render_vrc_segment)
        return scan(volume, tf, camera, config, light=light, **unit)
    if differentiable:
        if test:
            return a5_vjp.render_test_diff(volume, tf, camera, config,
                                           device=volume.data.device,
                                           segment=True, **unit)
        if slab_x:
            unit.update(x0=vi * slab_x, slab_x=slab_x)
        return march_vjp.render_vrc_diff(volume, tf, camera, config,
                                         device=volume.data.device,
                                         light=light, segment=True, **unit)
    if test:
        return a5.render_test_fused(volume, tf, camera, config, segment=True,
                                    **unit)
    if slab_x:
        unit.update(x0=vi * slab_x, slab_x=slab_x)
    return march.render_vrc_fused(volume, tf, camera, config, segment=True,
                                  **unit)


def _slab_halo_width(config: RenderConfig) -> int:
    """x-halo planes of a slab unit (render_dist.py:703): 2 (the a5 and
    trilinear corners' reach with their row wraps), widened under
    presmoothing to the Gaussian radius + 1, so that the owned voxels'
    smoothed gradients see their whole neighbourhood, and to radius + 2
    where the a1 samples are trilinear (``Interp.TRILINEAR``,
    ``TRILINEAR_COLOR``): a slab owns such a sample by its corners and
    shades it at its octree-NN voxel, which may lie one plane past the
    slab.  The JAX slab scan keeps radius + 1 (render_dist.py:703-710),
    and leaves its own single render there."""
    hw = 2
    if config.presmooth_sigma > 0.0:
        radius = max(1, int(3.0 * config.presmooth_sigma + 0.5))
        trilinear = (config.algorithm is Algorithm.VRC
                     and config.interp is not Interp.NEAREST)
        hw = max(hw, radius + (2 if trilinear else 1))
    return hw


def _with_x_halo(data: torch.Tensor, x0: int, slab_x: int, hw: int
                 ) -> torch.Tensor:
    """The planes [x0 - hw, x0 + slab_x + hw) of ``data`` [X, ...], zero
    planes past the volume's faces (render_dist.py:671).  Every rank holds
    the whole volume, so the halo is a slice of it, not a message between
    ranks."""
    d1 = data.shape[0]
    lo, hi = x0 - hw, x0 + slab_x + hw
    parts = [data[max(lo, 0):min(hi, d1)]]
    if lo < 0:
        parts.insert(0, data.new_zeros((-lo,) + data.shape[1:]))
    if hi > d1:
        parts.append(data.new_zeros((hi - d1,) + data.shape[1:]))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def _slab_gradient_from_ext(ext: torch.Tensor, config: RenderConfig,
                            hw: int, x0: int, d1: int) -> torch.Tensor:
    """Normals [slab_x + 2 hw, Y, Z, 3] on a halo-extended slab, equal to
    the whole volume's at the slab's voxels (render_dist.py:714): under
    presmoothing the smoothed planes outside the volume are zeroed before
    the gradient, as the whole volume's gradient reads zero padding
    there."""
    if config.presmooth_sigma > 0.0:
        sm = conv3d.gaussian_smooth(ext, config.presmooth_sigma)
        gx = torch.arange(-hw, ext.shape[0] - hw, device=ext.device) + x0
        sm = torch.where(((gx >= 0) & (gx < d1))[:, None, None], sm,
                         torch.zeros((), dtype=_f32, device=ext.device))
        if config.gradient_filter == "sobel":
            return conv3d.sobel_gradient(sm)
        return conv3d.central_difference_gradient(sm)
    return conv3d.gradient_field(ext, config.gradient_filter, 0.0)


def render_segment_volume_slab(volume, tf, camera, config: RenderConfig, *,
                               x_offset: int, local_width: int, s_start: int,
                               s_count: int, x0: int, slab_x: int,
                               light: Light | None = None):
    """The slab scan (``_render_segment_volume_slab``, render_dist.py:736):
    the work unit of columns [x_offset, x_offset + local_width) and samples
    [s_start, s_start + s_count) against the x-slab [x0, x0 + slab_x) of
    ``volume`` (the whole volume) -> its (C [w, H, 3], T [w, H, 1]) pair.

    A sample the slab does not own is the over identity (rgba 0), so the
    slabs folded in visibility order equal the single-device scan.
    Trilinear taps, a5 corners and the gradient normals of lighting read a
    slab extended by x-halos (:func:`_slab_halo_width` planes each side);
    scattering reads the slab of the whole volume's transmittance grid
    (``phong.light_transmittance_grid_slab``).  Each sample is classified
    as :func:`models.raycast._vrc_sample_rgba` or the a5 sampler classify
    it: a LUT, scattering and ``density_scale`` too (the module
    docstring).  Under autograd it marches in checkpointed chunks."""
    dev = volume.data.device
    d1, d2, d3 = dims = volume.dims
    data3d = volume.data if volume.channels == 1 else volume.data[..., 0]
    test = config.algorithm is Algorithm.TEST
    lit = phong.is_lit(config, light)
    if lit or config.scattering:
        light = phong.default_light(dev) if light is None else light
    hw = _slab_halo_width(config) if lit else 2
    ext = _with_x_halo(data3d, x0, slab_x, hw)
    ext_flat = ext.reshape(-1)
    ext_base = (x0 - hw) * (d2 * d3)
    ext_total = ext_flat.shape[0]
    zero = torch.zeros((), dtype=_f32, device=dev)
    grad_ext = (_slab_gradient_from_ext(ext, config, hw, x0, d1).reshape(-1, 3)
                if lit else None)
    tl_flat = None
    if config.scattering:
        phong.check_scatter_channels(volume.channels)
        alpha = tf.classify(volume.data.clamp_min(0.0)
                            / torch.trunc(volume.cal_max))[..., 3]
        alpha = phong.clip01(alpha * torch.tensor(
            config.density_scale, dtype=_f32, device=dev))
        tl_flat = phong.light_transmittance_grid_slab(
            alpha, light.direction, x0, slab_x).reshape(-1)

    def ext_index(flat, valid):
        """Global flat voxel index -> (index into the extended slab, ok)."""
        lflat = flat - ext_base
        ok = valid & (lflat >= 0) & (lflat < ext_total)
        return lflat.clamp(0, ext_total - 1), ok

    def shade(rgba, flat, valid, directions):
        lflat, ok = ext_index(flat, valid)
        normal = torch.where(ok[..., None], grad_ext[lflat], zero)
        return torch.cat([phong.phong_shade(rgba[..., :3], normal, None, light,
                                            directions), rgba[..., 3:4]],
                         dim=-1)

    def scatter(rgba, flat, valid, ray_dirs, v_norm):
        lflat = (flat - x0 * (d2 * d3)).clamp(0, slab_x * d2 * d3 - 1)
        return raycast._apply_scattering(rgba, tf, config,
                                         (tl_flat, light, ray_dirs), lflat,
                                         valid, v_norm)

    if test:
        x, y = raycast.pixel_grid(config, dev, x_offset, local_width)
        mats = a5.stage_matrices(camera, dims, config)
        if lit:
            a5_dirs = phong.shade_directions(-camera.front, light)
        dimv = torch.tensor(dims, dtype=_f32, device=dev)
        hi = torch.tensor(dims, dtype=torch.int64, device=dev) - 1

        def sample_rgba(i):
            pos = a5.apply_stages(mats, x, y, i)
            rgba, owned = sampling.trilinear_color_sample_slab(
                ext_flat, dims, pos, tf.classify, volume.cal_max, x0, slab_x,
                hw)
            if not lit and tl_flat is None:
                return rgba
            inside = ((pos >= 0.0) & (pos < dimv)).all(dim=-1) & owned
            ijk = torch.minimum(torch.trunc(pos).to(torch.int64).clamp_min(0),
                                hi)
            flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
            if lit:
                rgba = shade(rgba, flat, inside, a5_dirs)
            if tl_flat is not None:
                lflat, ok = ext_index(flat, inside)
                v = torch.where(ok, ext_flat[lflat].clamp_min(0.0), zero)
                rgba = scatter(rgba, flat, inside, camera.front,
                               v / volume.cal_max)
            return torch.where(owned[..., None], rgba, zero)
    else:
        origins = raycast.ray_origins(camera, config, x_offset, local_width)
        dirs = raycast.primary_ray_dirs(camera, config, x_offset,
                                        local_width)
        ds = torch.tensor(config.sample_distance, dtype=_f32, device=dev)
        clip = torch.tensor(config.front_clip, dtype=_f32, device=dev)
        if lit:
            a1_dirs = phong.shade_directions(-dirs, light)
        lut = tf.lut_intervals(config.tf_lut) if config.tf_lut else None
        depth = volume.octree_depth
        slab_flat = volume.data[x0:x0 + slab_x].reshape(
            -1, volume.channels).squeeze(-1)
        cal_trunc = torch.trunc(volume.cal_max)

        def sample_rgba(i):
            p = (origins + (i * ds + clip) * dirs) + 0.5
            v_norm = None
            if volume.channels > 1:
                lflat, valid, owned = sampling.octree_nn_index_slab(
                    dims, depth, p, x0, slab_x)
                v = slab_flat[lflat].clamp_min(0.0)
                v = torch.where((valid & owned)[..., None], v, zero)
                norm = v / volume.cal_max
                rgb = norm[..., :3] if volume.channels >= 3 else (
                    norm[..., :1].expand(*norm.shape[:-1], 3))
                alpha = tf.classify(march.channel_mean(norm))[..., 3:4]
                rgba = torch.cat([rgb, alpha], dim=-1)
            elif config.interp is Interp.TRILINEAR:
                v, owned = sampling.trilinear_intensity_sample_slab(
                    ext, dims, raycast._to_volume_space(p, volume), x0,
                    slab_x, hw)
                rgba = tf.classify_smooth(v / volume.cal_max,
                                          config.tf_sharpness)
            elif config.interp is Interp.TRILINEAR_COLOR:
                rgba, owned = sampling.trilinear_color_sample_slab(
                    ext_flat, dims, raycast._to_volume_space(p, volume),
                    tf.classify, volume.cal_max, x0, slab_x, hw)
            else:
                v, owned = sampling.octree_nn_sample_slab(
                    slab_flat, dims, depth, p, x0, slab_x)
                v_norm = v / cal_trunc
                if lut is not None:
                    n = lut.shape[0]
                    rgba = take_rows(tf.colors, lut[
                        torch.round(v_norm * (n - 1)).to(torch.int64)
                        .clamp(0, n - 1)])
                else:
                    rgba = tf.classify(v_norm)
            if lit or tl_flat is not None:
                flat, valid = sampling.octree_nn_index(dims, depth, p)
                valid = valid & owned
            if lit:
                rgba = shade(rgba, flat, valid, a1_dirs)
            if tl_flat is not None:
                rgba = scatter(rgba, flat, valid, dirs, v_norm)
            if config.density_scale != 1.0:
                a = rgba[..., 3:4] * torch.tensor(config.density_scale,
                                                  dtype=_f32, device=dev)
                rgba = torch.cat([rgba[..., :3], phong.clip01(a)], dim=-1)
            return torch.where(owned[..., None], rgba, zero)

    return raycast._march(sample_rgba, config, "segment", dev,
                          (local_width, config.height), s_start, s_count,
                          raycast.scan_chunk(volume, tf, camera, light))


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


# the JAX CLI's refusal of a sharded POINT render (cli.py:113-118)
POINT_MESH_MESSAGE = ("--mesh supports the ray-cast algorithms (vrc/test); "
                      "POINT splatting is a single-device path")


def sharded_refusal(volume, tf, config: RenderConfig,
                    shape: Tuple[int, int, int], light: Light | None = None,
                    differentiable: bool = False) -> str | None:
    """Why ``mode="fast"`` would refuse this sharded render (or, with
    ``differentiable``, fit) on a ``shape`` mesh, or None where the work
    units' kernels compute it: the unit checks (:func:`_check_route`,
    :func:`check_diff_route`) and the fused marches' own
    (``models/raycast.fast_refusal``, ``diff/fit.diff_refusal``).  Every
    rank decides alike, from the config alone."""
    slab = shard_sizes(volume, config, shape)[2] > 0
    try:
        if differentiable:
            check_diff_route(volume, tf, config, "fast", slab, light)
        else:
            _check_route(config, "fast", slab, light)
    except NotImplementedError as e:
        return str(e)
    if differentiable:
        from ..diff.fit import diff_refusal

        return diff_refusal(volume, tf, config, light)
    return raycast.fast_refusal(volume, tf, config, light)


def render_vrc_sharded(volume, tf, camera, config: RenderConfig, mesh: Mesh,
                       *, mode: str = "auto", light: Light | None = None,
                       differentiable: bool = False) -> torch.Tensor:
    """Distributed a1/VRC or a5/TEST render over ``mesh`` -> the full
    [W, H, 4] image (alpha 1) on every rank; ``Algorithm.POINT`` raises
    (:data:`POINT_MESH_MESSAGE`).

    Every rank passes the same ``volume`` (the whole volume; a volume-axis
    rank keeps its slab), TF, camera and config, on its own device.  The
    work unit of each rank and what raises are as the module docstring
    says; ``mode="scan"`` runs the plain scan segments on the rays and
    samples axes, and ``mode="auto"`` (the default) takes ``"fast"``
    where the units' kernels compute the config and ``"scan"`` otherwise
    (:func:`sharded_refusal`; the route is logged, as
    ``models/raycast.resolve_mode`` says).  The gathers run on the mesh's
    groups: NCCL on CUDA tensors, gloo on CPU tensors (or on CUDA tensors
    through the host).
    ``differentiable=True`` renders at eps 0 through the differentiable
    kernels, the image differentiable with respect to ``tf.colors`` (and
    ``light``'s fields on the rays and samples axes); each rank's gradients
    are then its own units' share, which ``Mesh.all_reduce_`` sums.
    """
    if config.algorithm is Algorithm.POINT:
        raise NotImplementedError(POINT_MESH_MESSAGE)
    if mode not in ("auto", "fast", "scan"):
        raise ValueError(f"unknown mode {mode!r}: a sharded render takes "
                         "'auto', 'fast' or 'scan'")
    shape = mesh.shape
    mode = raycast.resolve_mode(
        mode, lambda: sharded_refusal(volume, tf, config, shape, light,
                                      differentiable),
        "sharded fit" if differentiable else "sharded render")
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
