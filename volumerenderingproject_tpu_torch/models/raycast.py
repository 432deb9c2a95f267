"""The ray-cast renderers: a1/VRC and a5/TEST.

``render(volume, tf, camera, config) -> image [W, H, 4]``, indexed
``[pixel_x, pixel_y]`` like the reference's column-major screen buffer
(pixel id = x*SCR_HEIGHT + y, kernel.cu:25,199).  Per sample: world
position -> modelAux (+0.5, kernel.cu:1046-1063) -> octree nearest voxel ->
/ trunc(cal_max) -> transfer function (or its dense LUT, ``config.tf_lut``)
[-> Blinn-Phong on the voxel's density gradient, ``config.lighting``] ->
over-blend (kernel.cu:40-70, 194-225).

a5 (kernel.cu:72-187): camera-grid positions through modelCam ->
inverseView -> toVolume (kernel.cu:1177-1222), colour-space trilinear
sampling of the 8 classified corners [-> Blinn-Phong on the containing
voxel's gradient, viewed along ``-camera.front``], the same blend.

:func:`render` sends the a1 path to the fused march (``ops/march.py``) and
the a5 path to the fused a5 march (``ops/a5.py``): their CUDA kernels for
tensors on the GPU, their plain PyTorch versions for tensors on the CPU.
:func:`render_vrc` and :func:`render_test` are the plain scans beneath them,
Python loops over samples vectorised over rays: ``mode="fast"`` composites
front to back in (C, T) form, ``mode="reference"`` back to front in the
reference's exact order, ``mode="segment"`` returns the raw (C, T) pair.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ingest.volume import Volume
from ..ops import a5
from ..ops import composite as comp
from ..ops import conv3d, sampling
from ..ops.march import check_supported, render_vrc_fused
from ..ops.phong import Light, default_light, is_lit, phong_shade
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils import transforms as T
from ..utils.config import Algorithm, RenderConfig
from ..utils.device import resolve_device

_f32 = torch.float32


# ---------------------------------------------------------------------------
# Ray setup
# ---------------------------------------------------------------------------


def pixel_grid(config: RenderConfig, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel index grids X, Y of shape [W, H] (float32)."""
    w, h = config.width, config.height
    x = torch.arange(w, dtype=_f32, device=device)[:, None].expand(w, h)
    y = torch.arange(h, dtype=_f32, device=device)[None, :].expand(w, h)
    return x, y


def _screen_size(config: RenderConfig, device) -> torch.Tensor:
    """[W, H] as a float32 tensor: CUDA divides by a host scalar as a
    product with its reciprocal, not as the IEEE quotient."""
    return torch.tensor([config.width, config.height], dtype=_f32,
                        device=device)


def primary_ray_dirs(camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Per-pixel ray directions [W, H, 3] (rayDirectionKernel
    kernel.cu:20-38).  Ortho: cameraFront.  Conic: normalize(top_left
    + x*(w/W)*right + y*(h/H)*(-up) - cameraPos), with the corrected conic
    corner when ``config.conic_corrected``."""
    dev = camera.device
    if not config.conic:
        return camera.front.expand(config.width, config.height, 3)
    x, y = pixel_grid(config, dev)
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


def ray_origins(camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Per-pixel ray origins [W, H, 3].  Ortho: the pixel's point on the
    screen plane, ``(top_left + xterm) + yterm`` (kernel.cu:56-58).  Conic:
    cameraPos (kernel.cu:54)."""
    dev = camera.device
    if config.conic:
        return camera.position.expand(config.width, config.height, 3)
    x, y = pixel_grid(config, dev)
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
                     shading=None, lut: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """a1 per-sample classify: modelAux(+0.5) -> octree NN -> TF [-> Phong].

    ``shading``, when set, is a (grad_flat [X*Y*Z, 3], light, view_dir)
    triple: the gradient at the sample's voxel (0 off the volume) is the
    Phong normal.  ``lut``, when set, is the dense [N, 4] TF table used
    instead of the interval scan (``config.tf_lut``)."""
    p = positions + 0.5  # modelAux kernel.cu:1050
    flat, valid = sampling.octree_nn_index(volume.dims, volume.octree_depth, p)
    v = volume.data.reshape(-1)[flat].clamp_min(0.0)
    v = torch.where(valid, v, torch.zeros((), dtype=_f32, device=v.device))
    # the a1 kernel takes cal_max as an int (kernel.cu:42 `int max_intensity`)
    v_norm = v / torch.trunc(volume.cal_max)
    if lut is not None:
        n = lut.shape[0]
        idx = torch.round(v_norm * (n - 1)).to(torch.int64).clamp(0, n - 1)
        rgba = lut[idx]
    else:
        rgba = tf.classify(v_norm)
    if shading is not None:
        grad_flat, light, view_dir = shading
        normal = torch.where(valid[..., None], grad_flat[flat],
                             torch.zeros((), dtype=_f32, device=v.device))
        rgba = torch.cat([phong_shade(rgba[..., :3], normal, view_dir, light),
                          rgba[..., 3:4]], dim=-1)
    if config.density_scale != 1.0:
        a = rgba[..., 3:4] * torch.tensor(config.density_scale, dtype=_f32,
                                          device=rgba.device)
        rgba = torch.cat([rgba[..., :3], a.clamp(0.0, 1.0)], dim=-1)
    return rgba


def _gradient_flat(volume: Volume, config: RenderConfig) -> torch.Tensor:
    """The shading normals [X*Y*Z, 3] of ``config``'s gradient filter."""
    return conv3d.gradient_field(volume.data, config.gradient_filter,
                                 config.presmooth_sigma).reshape(-1, 3)


def _to_volume_space(p: torch.Tensor, volume: Volume) -> torch.Tensor:
    """NiftiFile::toVolumeSpace (BinaryLoader.cu:247-269) minus the +0.5
    (callers pass post-modelAux points): scale by L, center the dataset."""
    L = torch.tensor(float(volume.longest_dimension), dtype=_f32,
                     device=p.device)
    dimv = torch.tensor(volume.dims, dtype=_f32, device=p.device)
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
    (and with lighting the gradient field) are built once.  A lit sample
    takes the normal at its containing voxel clip(trunc(pos)), 0 outside
    the volume, viewed along ``-camera.front`` (the a5 grid marches along
    the front for every ray, kernel.cu:1190)."""
    vol_flat = volume.data.reshape(-1)
    mats = a5.stage_matrices(camera, volume.dims, config)
    lit = is_lit(config, light)
    if lit:
        light = default_light(camera.device) if light is None else light
        grad_flat = _gradient_flat(volume, config)
        view_dir = -camera.front
        dev = camera.device
        dimv = torch.tensor(volume.dims, dtype=_f32, device=dev)
        hi = torch.tensor(volume.dims, dtype=torch.int64, device=dev) - 1
        d1, d2, d3 = volume.dims

    def sample_rgba(i):
        pos = a5.apply_stages(mats, x, y, i)
        rgba = sampling.trilinear_color_sample(
            vol_flat, volume.dims, pos, tf.classify, volume.cal_max)
        if not lit:
            return rgba
        inside = ((pos >= 0.0) & (pos < dimv)).all(dim=-1)
        ijk = torch.minimum(torch.trunc(pos).to(torch.int64).clamp_min(0), hi)
        flat = ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2]
        normal = torch.where(inside[..., None], grad_flat[flat],
                             torch.zeros((), dtype=_f32, device=dev))
        return torch.cat([phong_shade(rgba[..., :3], normal, view_dir, light),
                          rgba[..., 3:4]], dim=-1)

    return sample_rgba


def _march(sample_rgba_fn, config: RenderConfig, mode: str, device):
    """Loop over the sample axis; ``sample_rgba_fn(i_f32) -> [W, H, 4]``.

    ``mode="segment"`` marches front to back and returns the raw (C, T)
    pair, the associative unit of sample-axis composition.
    """
    shape = (config.width, config.height)
    spr = config.samples_per_ray
    bg = torch.tensor(config.background, dtype=_f32, device=device)

    def step_value(i):
        return torch.tensor(float(i), dtype=_f32, device=device)

    if mode == "reference":
        acc = bg[:3].expand(*shape, 3)
        for i in reversed(range(spr)):
            acc = comp.over_step_btf(acc, sample_rgba_fn(step_value(i)))
        alpha = torch.ones(shape + (1,), dtype=_f32, device=device)
        return torch.cat([acc, alpha], dim=-1)

    if mode in ("fast", "segment"):
        seg = comp.segment_identity(shape, device)
        for i in range(spr):
            seg = comp.segment_update(seg, sample_rgba_fn(step_value(i)))
        if mode == "segment":
            return seg
        return comp.segment_finalize(seg, bg)

    raise ValueError(f"unknown mode {mode!r}")


def render_vrc(volume: Volume, tf: TransferFunction, camera: Camera,
               config: RenderConfig, *, mode: str = "fast",
               light: Light | None = None) -> torch.Tensor:
    """a1/VRC render by the plain scan -> [W, H, 4] (alpha all 1), or the
    (C [W, H, 3], T [W, H, 1]) pair with ``mode="segment"``.

    With ``config.lighting`` (or an explicit ``light``; the default light
    otherwise) samples are Phong-shaded on the gradient field of
    ``config.gradient_filter``/``presmooth_sigma``, viewed along each ray's
    ``-dir`` (ortho or conic); with ``config.tf_lut`` they classify through
    the dense LUT."""
    check_supported(config, volume.channels)
    origins = ray_origins(camera, config)
    dirs = primary_ray_dirs(camera, config)
    dev = origins.device
    ds = torch.tensor(config.sample_distance, dtype=_f32, device=dev)
    clip = torch.tensor(config.front_clip, dtype=_f32, device=dev)
    shading = None
    if is_lit(config, light):
        light = default_light(dev) if light is None else light
        shading = (_gradient_flat(volume, config), light, -dirs)
    lut = tf.to_lut(config.tf_lut) if config.tf_lut else None

    def sample_rgba(i):
        t = i * ds + clip  # kernel.cu:54,59
        return _vrc_sample_rgba(origins + t * dirs, volume, tf, config,
                                shading, lut)

    return _march(sample_rgba, config, mode, dev)


def render_test(volume: Volume, tf: TransferFunction, camera: Camera,
                config: RenderConfig, *, mode: str = "fast",
                light: Light | None = None) -> torch.Tensor:
    """a5/TEST render by the plain scan -> [W, H, 4] (alpha all 1), or the
    (C, T) pair with ``mode="segment"``; lit as :func:`_a5_sample_fn`
    says."""
    a5.check_supported(config, volume.channels)
    x, y = pixel_grid(config, camera.device)
    return _march(_a5_sample_fn(volume, tf, camera, config, x, y, light),
                  config, mode, camera.device)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def render(volume: Volume, tf: TransferFunction, camera: Camera,
           config: RenderConfig, *, mode: str = "fast",
           device=None, light: Light | None = None) -> torch.Tensor:
    """Render one frame -> [W, H, 4] on ``device`` (CUDA unless given),
    dispatching on ``config.algorithm``: a1/VRC or a5/TEST.

    ``mode="fast"`` runs the fused march with ``config.early_termination``
    as its epsilon: the CUDA kernel on the GPU, its plain version on the
    CPU.  ``mode="scan"`` runs the plain front-to-back scan (no early
    termination) and ``mode="reference"`` the back-to-front one.  A lit
    render (``config.lighting``, or an explicit ``light``) shades with the
    default light unless ``light`` is given; the fused marches take it
    through per-voxel (M, S) factors, so an a1 fast render needs ortho rays
    and a uniform light colour.
    """
    dev = resolve_device(device)
    test = config.algorithm is Algorithm.TEST
    if test:
        a5.check_supported(config, volume.channels)
    else:
        check_supported(config, volume.channels)
    if mode not in ("fast", "scan", "reference"):
        raise ValueError(f"unknown mode {mode!r}")
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    if light is not None:
        light = light.to(dev)
    if mode == "fast":
        fused = a5.render_test_fused if test else render_vrc_fused
        return fused(volume, tf, camera, config, light=light)
    scan = render_test if test else render_vrc
    return scan(volume, tf, camera, config,
                mode="fast" if mode == "scan" else mode, light=light)
