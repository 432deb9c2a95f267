"""The ray-cast renderers: a1/VRC and a5/TEST.

``render(volume, tf, camera, config) -> image [W, H, 4]``, indexed
``[pixel_x, pixel_y]`` like the reference's column-major screen buffer
(pixel id = x*SCR_HEIGHT + y, kernel.cu:25,199).  Per sample: world
position -> modelAux (+0.5, kernel.cu:1046-1063) -> octree nearest voxel ->
/ trunc(cal_max) -> transfer function (or its dense LUT, ``config.tf_lut``)
[-> Blinn-Phong on the voxel's density gradient, ``config.lighting``]
[-> + single-scattered light, ``config.scattering``] -> over-blend
(kernel.cu:40-70, 194-225).

With ``Interp.TRILINEAR_COLOR`` (raycast.py:168-174) an a1 sample takes
a5's colour-space trilinear mix of its 8 classified corners, at the
sample's voxel-space position; lit or scattered, it shades at the
octree-NN voxel.

A 4-D volume [X, Y, Z, C] (raycast.py:272-301) samples every channel at the
a1 voxel: rgb from channels 0-2 (channel 0 as grey for C = 2) over the float
cal_max, alpha from the TF of the channel mean; lit, it shades on the
gradient of channel 0, and it ignores a LUT.

a5 (kernel.cu:72-187): camera-grid positions through modelCam ->
inverseView -> toVolume (kernel.cu:1177-1222), colour-space trilinear
sampling of the 8 classified corners [-> Blinn-Phong on the containing
voxel's gradient, viewed along ``-camera.front``], the same blend.

:func:`render` sends the a1 path to the fused march (``ops/march.py``), or
in smooth mode (``Interp.TRILINEAR``: trilinear intensities through the
smooth TF) to the smooth march (``ops/smooth.py``), and the a5 path to the
fused a5 march (``ops/a5.py``): their CUDA kernels for
tensors on the GPU, their plain PyTorch versions for tensors on the CPU.
:func:`render_vrc` and :func:`render_test` are the plain scans beneath them,
Python loops over samples vectorised over rays: ``mode="fast"`` composites
front to back in (C, T) form, ``mode="reference"`` back to front in the
reference's exact order, ``mode="segment"`` returns the raw (C, T) pair.
They are also the port's scan route for fits (``diff/fit.py``,
``mode="scan"``): where autograd records through the volume, the TF, the
camera or the light, the front-to-back scan marches in chunks of
:data:`SCAN_CHUNK` samples under ``torch.utils.checkpoint``, which keeps
only the (C, T) carry at each chunk's start and recomputes the chunk's
samples in the backward pass (the JAX package's ``remat``,
raycast.py:358-401).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ingest.volume import Volume
from ..ops import a5
from ..ops import composite as comp
from ..ops import conv3d, march, sampling, smooth
from ..ops import phong
from ..ops.march import (channel_mean, check_fused_supported,
                         render_vrc_fused)
from ..ops.phong import Light, default_light, is_lit, phong_shade
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction, take_rows
from ..utils import transforms as T
from ..utils.config import Algorithm, Interp, RenderConfig
from ..utils.device import const, resolve_device

_f32 = torch.float32

# Samples of one checkpointed chunk of the scan under autograd.  A chunk
# keeps its samples' saved tensors alive while the backward pass recomputes
# it (40-165 bytes a ray-sample, by config), and each boundary keeps one
# (C, T) carry (16 bytes a ray).  On the H100 a full-width lit a5 or conic
# lit light fit step peaks 0.9-1.5 GiB above its start at 16, 2.5-4.7 GiB
# at 64, at the same speed within the noise (harness/scan_memory.py).
SCAN_CHUNK = 16


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------


def pixel_grid(config: RenderConfig, device=None, x_offset: int = 0,
               local_width: int | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel index grids X, Y of shape [w_local, H] (float32).  A ray shard
    owning columns [x_offset, x_offset + local_width) builds its grid with
    the global pixel indices, so its sample positions are unchanged
    (raycast.py:55-70)."""
    w = config.width if local_width is None else local_width
    h = config.height
    x = (torch.arange(w, dtype=_f32, device=device)
         + float(x_offset))[:, None].expand(w, h)
    y = torch.arange(h, dtype=_f32, device=device)[None, :].expand(w, h)
    return x, y


def _screen_size(config: RenderConfig, device) -> torch.Tensor:
    """[W, H] as a float32 tensor: CUDA divides by a host scalar as a
    product with its reciprocal, not as the IEEE quotient."""
    return torch.tensor([config.width, config.height], dtype=_f32,
                        device=device)


def primary_ray_dirs(camera: Camera, config: RenderConfig, x_offset: int = 0,
                     local_width: int | None = None) -> torch.Tensor:
    """Per-pixel ray directions [w_local, H, 3] (rayDirectionKernel
    kernel.cu:20-38) of columns [x_offset, x_offset + local_width).  Ortho:
    cameraFront.  Conic: normalize(top_left + x*(w/W)*right + y*(h/H)*(-up)
    - cameraPos), x the global column and W the global width, with the
    corrected conic corner when ``config.conic_corrected``."""
    dev = camera.device
    w_local = config.width if local_width is None else local_width
    if not config.conic:
        return camera.front.expand(w_local, config.height, 3)
    x, y = pixel_grid(config, dev, x_offset, w_local)
    w = torch.tensor(config.real_screen_width, dtype=_f32, device=dev)
    h = torch.tensor(config.real_screen_height, dtype=_f32, device=dev)
    size = _screen_size(config, dev)
    xt = ((x * w) / size[0])[..., None] * camera.right
    yt = ((y * h) / size[1])[..., None] * (-camera.up)
    top_left = camera.top_left
    if config.conic_corrected:
        # the intended conic corner (utils.h:63-65, commented out upstream)
        top_left = top_left + torch.tensor(
            config.viewplane_distance, dtype=_f32, device=dev) * camera.front
    return T.normalize(top_left + xt + yt - camera.position)


def ray_origins(camera: Camera, config: RenderConfig, x_offset: int = 0,
                local_width: int | None = None) -> torch.Tensor:
    """Per-pixel ray origins [w_local, H, 3] of columns [x_offset, x_offset
    + local_width).  Ortho: the pixel's point on the screen plane,
    ``(top_left + xterm) + yterm`` (kernel.cu:56-58).  Conic: cameraPos
    (kernel.cu:54)."""
    dev = camera.device
    w_local = config.width if local_width is None else local_width
    if config.conic:
        return camera.position.expand(w_local, config.height, 3)
    x, y = pixel_grid(config, dev, x_offset, w_local)
    w = torch.tensor(config.real_screen_width, dtype=_f32, device=dev)
    h = torch.tensor(config.real_screen_height, dtype=_f32, device=dev)
    size = _screen_size(config, dev)
    xt = ((x * w) / size[0])[..., None] * camera.right
    yt = ((y * h) / size[1])[..., None] * (-camera.up)
    return (camera.top_left + xt) + yt


# ---------------------------------------------------------------------------
# Per-sample colour and the march
# ---------------------------------------------------------------------------


def _vrc_sample_rgba(positions: torch.Tensor, volume: Volume,
                     tf: TransferFunction, config: RenderConfig,
                     shading=None, lut: torch.Tensor | None = None,
                     scatter=None) -> torch.Tensor:
    """a1 per-sample classify: modelAux(+0.5) -> octree NN -> TF [-> Phong]
    [-> scattering], or in smooth mode (``Interp.TRILINEAR``) modelAux ->
    voxel space -> trilinear intensity -> smooth TF, or with
    ``Interp.TRILINEAR_COLOR`` modelAux -> voxel space -> the a5 colour
    mix [-> Phong and scattering at the octree-NN voxel].

    ``shading``, when set, is a (grad_flat [X*Y*Z, 3], light,
    ``phong.shade_directions``) triple: the gradient at the sample's voxel
    (0 off the volume) is the Phong normal.  ``lut``, when set, is the
    interval [N] of each entry of the dense TF table used instead of the
    interval scan (``config.tf_lut``, ``TransferFunction.lut_intervals``):
    the sample takes the colour of its entry's interval, the entry's
    colour.  ``scatter``, when set, is :func:`_make_scatter`'s triple
    (raycast.py:142-222).  A 4-D
    volume samples its channels (:func:`_vrc_sample_rgba_multichannel`)
    whatever ``config.interp`` says, without the LUT."""
    p = positions + 0.5  # modelAux kernel.cu:1050
    flat = valid = None
    if volume.channels > 1:
        rgba, flat, valid = _vrc_sample_rgba_multichannel(p, volume, tf)
    elif config.interp is Interp.TRILINEAR:
        # smooth mode: trilinear intensities over the float cal_max (no
        # negative clamp) through the smooth TF (raycast.py:161-167)
        v = sampling.trilinear_intensity_sample(
            volume.data, _to_volume_space(p, volume))
        rgba = tf.classify_smooth(v / volume.cal_max, config.tf_sharpness)
    elif config.interp is Interp.TRILINEAR_COLOR:
        # the a5 colour mix on the a1 rays (raycast.py:168-174): corners
        # over the float cal_max, TF(0)'s colour off the volume, no LUT
        rgba = sampling.trilinear_color_sample(
            volume.data.reshape(-1), volume.dims, _to_volume_space(p, volume),
            tf.classify, volume.cal_max)
    else:
        flat, valid = sampling.octree_nn_index(volume.dims,
                                               volume.octree_depth, p)
        v = volume.data.reshape(-1)[flat].clamp_min(0.0)
        v = torch.where(valid, v, torch.zeros((), dtype=_f32,
                                              device=v.device))
        # the a1 kernel takes cal_max as an int (kernel.cu:42 `int
        # max_intensity`)
        v_norm = v / torch.trunc(volume.cal_max)
        if lut is not None:
            n = lut.shape[0]
            idx = torch.round(v_norm * (n - 1)).to(torch.int64).clamp(0, n - 1)
            rgba = take_rows(tf.colors, lut[idx])
        else:
            rgba = tf.classify(v_norm)
    if shading is not None:
        grad_flat, light, directions = shading
        if flat is None:  # smooth mode shades at the octree-NN voxel
            flat, valid = sampling.octree_nn_index(volume.dims,
                                                   volume.octree_depth, p)
        normal = torch.where(valid[..., None], grad_flat[flat],
                             torch.zeros((), dtype=_f32, device=p.device))
        rgba = torch.cat([phong_shade(rgba[..., :3], normal, None, light,
                                      directions), rgba[..., 3:4]], dim=-1)
    if scatter is not None:
        if flat is None:
            flat, valid = sampling.octree_nn_index(volume.dims,
                                                   volume.octree_depth, p)
        v = volume.data.reshape(-1)[flat].clamp_min(0.0)
        v = torch.where(valid, v, torch.zeros((), dtype=_f32,
                                              device=v.device))
        rgba = _apply_scattering(rgba, tf, config, scatter, flat, valid,
                                 v / torch.trunc(volume.cal_max))
    if config.density_scale != 1.0:
        a = rgba[..., 3:4] * const(float(config.density_scale), rgba.device)
        rgba = torch.cat([rgba[..., :3], phong.clip01(a)], dim=-1)
    return rgba


def _vrc_sample_rgba_multichannel(p: torch.Tensor, volume: Volume,
                                  tf: TransferFunction):
    """4-D sampling (raycast.py:272-301) at post-modelAux points -> (rgba
    [..., 4], flat, valid): every channel at the a1 voxel, ``max(v, 0)``,
    0 off the volume, over the float ``cal_max`` (not trunc); rgb from
    channels 0-2 (channel 0 broadcast to grey for C = 2), alpha from the
    TF of the channel mean (``density_scale`` is the caller's)."""
    flat, valid = sampling.octree_nn_index(volume.dims, volume.octree_depth,
                                           p)
    v = volume.data.reshape(-1, volume.channels)[flat].clamp_min(0.0)
    v = torch.where(valid[..., None], v,
                    torch.zeros((), dtype=_f32, device=v.device))
    norm = v / volume.cal_max
    rgb = norm[..., :3] if volume.channels >= 3 else norm[..., :1].expand(
        *norm.shape[:-1], 3)
    alpha = tf.classify(channel_mean(norm))[..., 3:4]
    return torch.cat([rgb, alpha], dim=-1), flat, valid


def _apply_scattering(rgba: torch.Tensor, tf: TransferFunction,
                      config: RenderConfig, scatter, flat: torch.Tensor,
                      valid: torch.Tensor, v_norm: torch.Tensor
                      ) -> torch.Tensor:
    """Add single-scattered radiance to the sample colours
    (raycast.py:225-251): ``rgb += strength * (HG(cos t; g) * T_light) *
    light.color``, with g the material of ``v_norm``'s interval, T_light
    the transmittance grid at the sample's voxel (0 off the volume) and
    cos t = ray_dir . light_dir."""
    tl_flat, light, ray_dirs = scatter
    tl = torch.where(valid, sampling.take(tl_flat, flat),
                     torch.zeros((), dtype=_f32, device=flat.device))
    gk = tf.hg_g[tf.classify_index(v_norm)]
    ldir = light.direction / phong.norm3(light.direction).clamp_min(1e-8)
    cos_t = phong.dot3(ray_dirs, ldir)
    ph = phong.henyey_greenstein(cos_t, gk)
    add = (const(float(config.scattering_strength), ph.device)
           * (ph * tl)[..., None]) * light.color
    return torch.cat([rgba[..., :3] + add, rgba[..., 3:4]], dim=-1)


def _make_scatter(volume: Volume, tf: TransferFunction,
                  config: RenderConfig, light: Light | None,
                  ray_dirs: torch.Tensor):
    """The per-call scattering inputs (raycast.py:254-270): the
    transmittance grid [X*Y*Z] of ``clip(alpha * density_scale)`` under a1
    value semantics (trunc(cal_max)), the light (the default one unless
    given) and the ray directions.  One channel only, as in the JAX
    package."""
    phong.check_scatter_channels(volume.channels)
    if light is None:
        light = default_light(volume.data.device)
    alpha = tf.classify(volume.data.clamp_min(0.0)
                        / torch.trunc(volume.cal_max))[..., 3]
    alpha = phong.clip01(alpha * torch.tensor(
        config.density_scale, dtype=_f32, device=alpha.device))
    tgrid = phong.light_transmittance_grid(alpha, light.direction)
    return tgrid.reshape(-1), light, ray_dirs


def _gradient_flat(volume: Volume, config: RenderConfig) -> torch.Tensor:
    """The shading normals [X*Y*Z, 3] of ``config``'s gradient filter, on
    channel 0 of a 4-D volume (raycast.py:432, 543)."""
    data = volume.data if volume.channels == 1 else volume.data[..., 0]
    return conv3d.gradient_field(data, config.gradient_filter,
                                 config.presmooth_sigma).reshape(-1, 3)


def _to_volume_space(p: torch.Tensor, volume: Volume) -> torch.Tensor:
    """NiftiFile::toVolumeSpace (BinaryLoader.cu:247-269) minus the +0.5
    (callers pass post-modelAux points): scale by L, center the dataset."""
    L = const(float(volume.longest_dimension), p.device)
    dimv = const(tuple(float(d) for d in volume.dims), p.device)
    return p * L + (dimv / 2.0 - L / 2.0)


def _a5_positions(x: torch.Tensor, y: torch.Tensor, i: torch.Tensor,
                  camera: Camera, volume: Volume, config: RenderConfig
                  ) -> torch.Tensor:
    """a5 sample positions in voxel space, applying the three stage matrices
    sequentially like the kernel (kernel.cu:100-115)."""
    return a5.apply_stages(a5.stage_matrices(camera, volume.dims, config),
                           x, y, i)


def _a5_sample_fn(volume: Volume, tf: TransferFunction, camera: Camera,
                  config: RenderConfig, x: torch.Tensor, y: torch.Tensor,
                  light: Light | None = None):
    """The a5 per-step sampler ``i_f32 -> [W, H, 4]``; the stage matrices
    (and with lighting the gradient field, with scattering the
    transmittance grid) are built once.  A lit sample takes the normal at
    its containing voxel clip(trunc(pos)), 0 outside the volume, viewed
    along ``-camera.front`` (the a5 grid marches along the front for every
    ray, kernel.cu:1190); a scattered sample takes the transmittance and
    the material of that voxel (its intensity over the float cal_max),
    with the ray direction ``camera.front`` (raycast.py:531-586)."""
    vol_flat = volume.data.reshape(-1)
    mats = a5.stage_matrices(camera, volume.dims, config)
    lit = is_lit(config, light)
    scatter = (_make_scatter(volume, tf, config, light, camera.front)
               if config.scattering else None)
    if lit or scatter is not None:
        light = default_light(camera.device) if light is None else light
        dev = camera.device
        zero = torch.zeros((), dtype=_f32, device=dev)
        dimv = torch.tensor(volume.dims, dtype=_f32, device=dev)
        hi = torch.tensor(volume.dims, dtype=torch.int64, device=dev) - 1
        d1, d2, d3 = volume.dims
    if lit:
        grad_flat = _gradient_flat(volume, config)
        directions = phong.shade_directions(-camera.front, light)

    def sample_rgba(i):
        pos = a5.apply_stages(mats, x, y, i)
        rgba = sampling.trilinear_color_sample(
            vol_flat, volume.dims, pos, tf.classify, volume.cal_max)
        if not lit and scatter is None:
            return rgba
        inside = ((pos >= 0.0) & (pos < dimv)).all(dim=-1)
        ijk = torch.minimum(torch.trunc(pos).to(torch.int64).clamp_min(0), hi)
        flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
        if lit:
            normal = torch.where(inside[..., None], grad_flat[flat], zero)
            rgba = torch.cat([phong_shade(rgba[..., :3], normal, None, light,
                                          directions), rgba[..., 3:4]],
                             dim=-1)
        if scatter is not None:
            v = torch.where(inside, vol_flat[flat].clamp_min(0.0), zero)
            rgba = _apply_scattering(rgba, tf, config, scatter, flat, inside,
                                     v / volume.cal_max)
        return rgba

    return sample_rgba


def scan_chunk(*objs) -> int | None:
    """:data:`SCAN_CHUNK` when autograd records through a tensor of
    ``objs`` (volumes, TFs, cameras, lights; None skipped), else None: the
    chunk length the scans take."""
    if not torch.is_grad_enabled():
        return None
    for obj in objs:
        if obj is None:
            continue
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return SCAN_CHUNK
    return None


def _march(sample_rgba_fn, config: RenderConfig, mode: str, device,
           shape: Tuple[int, int] | None = None, s_start: int = 0,
           s_count: int | None = None, chunk: int | None = None):
    """Loop over samples [s_start, s_start + s_count) (all of them by
    default); ``sample_rgba_fn(i_f32) -> [*shape, 4]``, ``shape`` [W, H]
    unless given.

    ``mode="segment"`` marches front to back and returns the raw (C, T)
    pair, the associative unit of sample-axis composition.  With ``chunk``
    the front-to-back scan runs each ``chunk`` samples under non-reentrant
    ``torch.utils.checkpoint``, which sees the tensors the sampler closes
    over: the same operations in the same order, so values and gradients
    equal the unchunked scan's bit for bit.
    """
    shape = shape or (config.width, config.height)
    spr = config.samples_per_ray if s_count is None else s_count
    steps = range(s_start, s_start + spr)
    bg = torch.tensor(config.background, dtype=_f32, device=device)
    # every sample index as a float32 on the device, made at once: exact
    # integers, as float(i) rounds them
    step_values = torch.arange(s_start, s_start + spr, dtype=_f32,
                               device=device)

    def step_value(i):
        return step_values[i - s_start]

    if mode == "reference":
        acc = bg[:3].expand(*shape, 3)
        for i in reversed(steps):
            acc = comp.over_step_btf(acc, sample_rgba_fn(step_value(i)))
        alpha = torch.ones(shape + (1,), dtype=_f32, device=device)
        return torch.cat([acc, alpha], dim=-1)

    if mode in ("fast", "segment"):
        seg = comp.segment_identity(shape, device)
        if chunk:
            def run(c, t, lo, hi):
                seg = (c, t)
                for i in range(lo, hi):
                    seg = comp.segment_update(seg,
                                              sample_rgba_fn(step_value(i)))
                return seg

            for lo in range(steps.start, steps.stop, chunk):
                seg = checkpoint(run, *seg, lo, min(lo + chunk, steps.stop),
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            for i in steps:
                seg = comp.segment_update(seg, sample_rgba_fn(step_value(i)))
        if mode == "segment":
            return seg
        return comp.segment_finalize(seg, bg)

    raise ValueError(f"unknown mode {mode!r}")


def _vrc_sampler(volume: Volume, tf: TransferFunction, camera: Camera,
                 config: RenderConfig, light: Light | None, x_offset: int,
                 local_width: int | None):
    """The a1 per-step sampler ``i_f32 -> [w_local, H, 4]`` of columns
    [x_offset, x_offset + local_width); the gradient field, LUT and
    transmittance grid are built once."""
    origins = ray_origins(camera, config, x_offset, local_width)
    dirs = primary_ray_dirs(camera, config, x_offset, local_width)
    dev = origins.device
    ds = torch.tensor(config.sample_distance, dtype=_f32, device=dev)
    clip = torch.tensor(config.front_clip, dtype=_f32, device=dev)
    shading = None
    if is_lit(config, light):
        light = default_light(dev) if light is None else light
        shading = (_gradient_flat(volume, config), light,
                   phong.shade_directions(-dirs, light))
    lut = tf.lut_intervals(config.tf_lut) if config.tf_lut else None
    scatter = (_make_scatter(volume, tf, config, light, dirs)
               if config.scattering else None)

    def sample_rgba(i):
        t = i * ds + clip  # kernel.cu:54,59
        return _vrc_sample_rgba(origins + t * dirs, volume, tf, config,
                                shading, lut, scatter)

    return sample_rgba


def render_vrc(volume: Volume, tf: TransferFunction, camera: Camera,
               config: RenderConfig, *, mode: str = "fast",
               light: Light | None = None) -> torch.Tensor:
    """a1/VRC render by the plain scan -> [W, H, 4] (alpha all 1), or the
    (C [W, H, 3], T [W, H, 1]) pair with ``mode="segment"``.

    With ``config.lighting`` (or an explicit ``light`` without scattering;
    the default light otherwise) samples are Phong-shaded on the gradient
    field of ``config.gradient_filter``/``presmooth_sigma``, viewed along
    each ray's ``-dir`` (ortho or conic); with ``config.tf_lut`` they
    classify through the dense LUT; with ``config.scattering`` they gain
    the light's single-scattered radiance along each ray's ``dir``."""
    return _march(_vrc_sampler(volume, tf, camera, config, light, 0, None),
                  config, mode, camera.device,
                  chunk=scan_chunk(volume, tf, camera, light))


def render_vrc_segment(volume: Volume, tf: TransferFunction, camera: Camera,
                       config: RenderConfig, *, x_offset: int = 0,
                       local_width: int | None = None, s_start: int = 0,
                       s_count: int | None = None,
                       light: Light | None = None):
    """The sharded a1 work unit by the plain scan (raycast.py:451): columns
    [x_offset, x_offset + local_width) x samples [s_start, s_start +
    s_count) -> the front-to-back (C [w, H, 3], T [w, H, 1]) pair, which
    ``ops/composite.segment_compose`` composes across shards."""
    w_local = config.width if local_width is None else local_width
    return _march(
        _vrc_sampler(volume, tf, camera, config, light, x_offset, w_local),
        config, "segment", camera.device, (w_local, config.height), s_start,
        s_count, scan_chunk(volume, tf, camera, light))


def render_test(volume: Volume, tf: TransferFunction, camera: Camera,
                config: RenderConfig, *, mode: str = "fast",
                light: Light | None = None) -> torch.Tensor:
    """a5/TEST render by the plain scan -> [W, H, 4] (alpha all 1), or the
    (C, T) pair with ``mode="segment"``; lit as :func:`_a5_sample_fn`
    says.  A 4-D volume is read as the JAX scan reads it
    (raycast.py:536): its flat array, channels interleaved, indexed by
    voxel (the reference's ``flat < totaldim`` guard keeps every index in
    the first X*Y*Z values), and lit on the gradient of channel 0."""
    x, y = pixel_grid(config, camera.device)
    return _march(_a5_sample_fn(volume, tf, camera, config, x, y, light),
                  config, mode, camera.device,
                  chunk=scan_chunk(volume, tf, camera, light))


def render_test_segment(volume: Volume, tf: TransferFunction,
                        camera: Camera, config: RenderConfig, *,
                        x_offset: int = 0, local_width: int | None = None,
                        s_start: int = 0, s_count: int | None = None,
                        light: Light | None = None):
    """The sharded a5 work unit by the plain scan (raycast.py:590): as
    :func:`render_vrc_segment`; the a5 camera grid is indexed by global
    pixel coordinates, so the local grid carries the column offset."""
    w_local = config.width if local_width is None else local_width
    x, y = pixel_grid(config, camera.device, x_offset, w_local)
    return _march(_a5_sample_fn(volume, tf, camera, config, x, y, light),
                  config, "segment", camera.device, (w_local, config.height),
                  s_start, s_count, scan_chunk(volume, tf, camera, light))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


# the log of the route ``mode="auto"`` takes (module docstring, ``render``)
route_log = logging.getLogger("volumerenderingproject_tpu_torch.route")


def fast_refusal(volume: Volume, tf: TransferFunction, config: RenderConfig,
                 light: Light | None = None) -> str | None:
    """Why :func:`render`'s ``mode="fast"`` would refuse this config (the
    message of the fused march's check that raises), or None where a
    kernel renders it: ``ops/march.check_fused_supported`` (and the id
    grid's 256 intervals and 1024 LUT entries) for a1,
    ``ops/smooth.check_smooth_supported`` in smooth mode,
    ``ops/a5.check_fused_supported`` for a5.  ``Algorithm.POINT`` has no
    kernel and no refusal."""
    try:
        if config.algorithm is Algorithm.TEST:
            a5.check_fused_supported(volume.channels, light)
        elif config.algorithm is Algorithm.POINT:
            return None
        elif config.interp is Interp.TRILINEAR:
            smooth.check_smooth_supported(config, tf.num_intervals, light,
                                          volume.channels)
        else:
            check_fused_supported(config, light, volume.channels)
            if tf.num_intervals > march.MAX_INTERVALS:
                return (f"the fused march's id grid holds at most "
                        f"{march.MAX_INTERVALS} intervals")
            if config.tf_lut > march.MAX_LUT:
                return (f"the fused march takes a LUT of at most "
                        f"{march.MAX_LUT} entries")
    except NotImplementedError as e:
        return str(e)
    return None


def resolve_mode(mode: str, refusal, what: str) -> str:
    """The route of a call given ``mode``: ``"auto"`` becomes ``"fast"``
    where ``refusal()`` (a thunk of the fast route's checks, e.g.
    :func:`fast_refusal`) is None, else ``"scan"``, as the JAX package's
    default takes a fused kernel where one is eligible and its XLA scan
    otherwise; the route is logged once a call on :data:`route_log`, at
    INFO (a scan step takes seconds where a kernel step takes
    milliseconds).  Any other mode is returned as it is."""
    if mode != "auto":
        return mode
    why = refusal()
    route = "fast" if why is None else "scan"
    route_log.info("%s: mode='auto' takes the %s route%s", what,
                   "kernel" if why is None else "scan",
                   "" if why is None else f" ({why})")
    return route


def render(volume: Volume, tf: TransferFunction, camera: Camera,
           config: RenderConfig, *, mode: str = "auto",
           device=None, light: Light | None = None) -> torch.Tensor:
    """Render one frame -> [W, H, 4] on ``device`` (CUDA unless given),
    dispatching on ``config.algorithm``: a1/VRC, a5/TEST or the a0 voxel
    point cloud (``Algorithm.POINT``, ``models/point_splat.render_points``
    in every mode, as the JAX package's ``render`` does).

    ``mode="auto"`` (the default) takes ``"fast"`` where a kernel renders
    the config and ``"scan"`` otherwise (:func:`fast_refusal`), and logs
    the route (:func:`resolve_mode`).
    ``mode="fast"`` runs the fused march with ``config.early_termination``
    as its epsilon: the CUDA kernel on the GPU, its plain version on the
    CPU.  ``mode="scan"`` runs the plain front-to-back scan (no early
    termination) and ``mode="reference"`` the back-to-front one.  A lit
    render (``config.lighting``, or an explicit ``light``) shades with the
    default light unless ``light`` is given; the fused a1 march takes it
    through per-voxel (M, S) factors on ortho rays under a uniform light
    colour, and in the kernel (central differences at presmooth 0 only)
    on conic rays or under any other colour; the fused a5 march through
    the factors.  A 4-D a1 volume renders through the march's channel
    variant, ortho or conic, unlit and without a LUT (a lit or LUT one in
    ``mode="scan"``, as the JAX package's scan renders it); a 4-D a5 volume
    renders in ``mode="scan"`` only.  A smooth render
    (``Interp.TRILINEAR``, a1) runs the smooth march (``ops/smooth.py``)
    in fast mode, which takes the plain smooth classify of one channel
    only: lit, LUT, ``density_scale != 1`` and 4-D smooth renders raise
    there and render in ``mode="scan"``.  An a1 render with
    ``Interp.TRILINEAR_COLOR`` raises in fast mode, as no kernel samples
    it (raycast.py:683), and renders in ``mode="scan"``.
    """
    dev = resolve_device(device)
    if mode not in ("auto", "fast", "scan", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    if config.algorithm is Algorithm.POINT:
        from . import point_splat

        return point_splat.render_points(volume, tf, camera, config)
    test = config.algorithm is Algorithm.TEST
    if light is not None:
        light = light.to(dev)
    mode = resolve_mode(
        mode, lambda: fast_refusal(volume, tf, config, light), "render")
    if mode == "fast":
        if test:
            fused = a5.render_test_fused
        elif config.interp is Interp.TRILINEAR:
            fused = smooth.render_vrc_smooth_fused
        else:
            fused = render_vrc_fused
        return fused(volume, tf, camera, config, light=light)
    scan = render_test if test else render_vrc
    return scan(volume, tf, camera, config,
                mode="fast" if mode == "scan" else mode, light=light)
