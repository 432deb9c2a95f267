"""POINT / a0 mode: the voxel point cloud, rasterized in software.

The reference draws one GL_POINT per voxel (myApp.cu:955-981) with
  model      = translate(I, (-0.5,-0.5,-0.5))            (myApp.cu:170-171)
  view       = lookAt(cameraPos, origin, cameraUp)       (myApp.cu:960)
  projection = ortho(-1, 1, -1, 1, -1.5, 1.5)            (myApp.cu:182)
vertex positions are the longest-dimension-centered voxel coords
((x + L/2 - dim/2)/L, prepareVolumeColors myApp.cu:1302-1304), colours
come from the transfer function, and the fragment shader discards alpha
== 0 (3.3.point_shader.fs:6-8).  The depth test is LESS with alpha
blending in voxel draw order.

:func:`render_points` resolves visibility on the device with a depth
buffer: the nearest surviving voxel per pixel (``scatter_reduce`` "amin"
on z into the ``W*H`` pixels' buckets and :data:`SENTINELS` more for the
culled voxels, where the JAX package has one sentinel bucket),
ties broken by the lowest voxel index (the first drawn, which GL_LESS
keeps), then blends the winner over the background.  Occluded voxels drawn
later do not accumulate, as they do in GL (the reference's draw-order
blending): an approximation, as in the JAX package (point_splat.py:1-20).
``exact=True`` rasterizes in draw order on the host through the native
library (``native.point_rasterize``), with GL's blending and depth writes;
the ndc and colours are computed on the device and copied.  Every function
follows the JAX package's float order (point_splat.py:36-244).

4-D volumes classify their channel 0, as the JAX package's exact and depth
paths do.
"""

from __future__ import annotations

import torch

from ..ingest.volume import Volume
from ..ops import sampling
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils import transforms as T
from ..utils.config import RenderConfig
from ..utils.device import const

_f32 = torch.float32

# buckets past the image that take the culled voxels, spread by voxel
# index: into one bucket, every culled voxel's atomic on the card waits
# for the one before (most of a voxel cloud is culled)
SENTINELS = 1024


def _channel0(volume: Volume) -> torch.Tensor:
    data = volume.data if volume.channels == 1 else volume.data[..., 0]
    return data.reshape(-1)


def voxel_positions(volume: Volume) -> torch.Tensor:
    """Longest-dimension-centered normalized voxel coords [N, 3] on the
    volume's device (prepareVolumeColors myApp.cu:1302-1304)."""
    dev = volume.data.device
    dims = volume.dims
    L = float(volume.longest_dimension)
    axes = []
    for a, d in enumerate(dims):
        shape = [1, 1, 1]
        shape[a] = d
        i = torch.arange(d, dtype=_f32, device=dev).reshape(shape)
        p = ((i + const(L / 2.0, dev)) - const(d / 2.0, dev)) / const(L, dev)
        axes.append(p.expand(dims))
    return torch.stack(axes, dim=-1).reshape(-1, 3)


def _ndc(volume: Volume, camera: Camera) -> torch.Tensor:
    """Every voxel's normalized device coordinates [N, 3] (ortho: w stays
    1): projection @ view @ model applied to :func:`voxel_positions`."""
    dev = volume.data.device
    mvp = T.matmul(T.matmul(T.ortho(-1.0, 1.0, -1.0, 1.0, -1.5, 1.5, dev),
                            camera.look_at_origin_view()),
                   T.translation((-0.5, -0.5, -0.5), dev))
    return T.apply(mvp, voxel_positions(volume))


def _pixels(ndc: torch.Tensor, config: RenderConfig):
    """(pixel bucket [N], in-frame mask [N], z [N], sentinel bucket [N]):
    the bucket of a voxel outside the frame or the depth range is its
    sentinel, ``W*H + index % SENTINELS``; GL's window y is up, the
    image's row 0 the top."""
    w, h = config.width, config.height
    px = torch.floor((ndc[..., 0] + 1.0) * 0.5 * w).to(torch.int64)
    py = torch.floor((ndc[..., 1] + 1.0) * 0.5 * h).to(torch.int64)
    z = ndc[..., 2]
    valid = ((px >= 0) & (px < w) & (py >= 0) & (py < h)
             & (z >= -1.0) & (z <= 1.0))
    pix = px * h + (h - 1 - py)
    trash = w * h + torch.arange(pix.shape[0], device=pix.device) % SENTINELS
    return torch.where(valid, pix, trash), valid, z, trash


def _segment_min(values: torch.Tensor, pix: torch.Tensor, n: int,
                 init) -> torch.Tensor:
    """``jax.ops.segment_min`` over ``n`` buckets, empty ones at ``init``."""
    out = torch.full((n,), init, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, pix, values, "amin", include_self=True)


def render_points(volume: Volume, tf: TransferFunction, camera: Camera,
                  config: RenderConfig, *, exact: bool = False,
                  rgba: torch.Tensor | None = None) -> torch.Tensor:
    """Rasterize the voxel cloud -> [W, H, 4] image on the volume's device.

    ``exact=True`` takes the native rasterizer (GL draw-order blending and
    depth writes, on the host); the default is the depth-buffer
    approximation on the device (the module docstring).  ``rgba``
    overrides the per-voxel colours [N, 4] (``models/debug_colors.py``,
    ``scene/voxel_colors.py``, the reference's prepareVolumeColors
    colorTest switch, myApp.cu:1296-1312); the exact path takes the TF's,
    as in the JAX package."""
    if exact:
        return _render_points_exact(volume, tf, camera, config)
    dev = volume.data.device
    w, h = config.width, config.height
    n_pix = w * h
    if rgba is None:
        # the float cal_max, as the JAX package's point path divides
        rgba = tf.classify(_channel0(volume) / volume.cal_max)
    rgba = rgba.to(dev, _f32)
    pix, valid, z, trash = _pixels(_ndc(volume, camera), config)
    valid = valid & (rgba[..., 3] > 0.0)  # the shader's discard
    pix = torch.where(valid, pix, trash)
    n_buckets = n_pix + SENTINELS
    inf = torch.full_like(z, float("inf"))
    zmin = _segment_min(torch.where(valid, z, inf), pix, n_buckets,
                        float("inf"))
    is_front = valid & (z == zmin[pix])
    n_vox = pix.shape[0]
    vox_idx = torch.arange(n_vox, dtype=torch.int64, device=dev)
    idx_min = _segment_min(
        torch.where(is_front, vox_idx, torch.full_like(vox_idx, n_vox)), pix,
        n_buckets, n_vox)
    winner = is_front & (vox_idx == idx_min[pix])
    # one winner a pixel: its colour, 0 where none won
    flat = torch.zeros((n_pix, 4), dtype=_f32, device=dev)
    flat[pix[winner]] = rgba[winner]
    bg = const(tuple(config.background), dev)
    a = flat[..., 3:4]
    rgb = bg[:3] * (1.0 - a) + flat[..., :3] * a
    img = torch.cat([rgb, torch.ones_like(a)], dim=-1)
    return img.reshape(w, h, 4)


def _render_points_exact(volume: Volume, tf: TransferFunction,
                         camera: Camera, config: RenderConfig
                         ) -> torch.Tensor:
    """The native rasterizer's image: GL draw-order blending and depth
    writes, on the host; the ndc and colours from the device."""
    from .. import native

    rgba = tf.classify(_channel0(volume) / volume.cal_max)
    ndc = _ndc(volume, camera)
    img = native.point_rasterize(
        ndc.cpu().numpy(), rgba.detach().cpu().numpy(), config.width,
        config.height, torch.tensor(config.background, dtype=_f32).numpy())
    return torch.from_numpy(img).to(volume.data.device)


def render_points_depth(volume: Volume, camera: Camera,
                        config: RenderConfig) -> torch.Tensor:
    """Depth-buffer image of the voxel cloud -> [W, H, 4] grey.

    The counterpart of the reference's z-buffer shader
    (3.3.zbuffershader.fs:1-16: FragColor = vec3(gl_FragCoord.z), the
    window depth of whatever wins the depth test; no alpha discard).  The
    window depth of the ortho pipeline is (ndc_z + 1) / 2; pixels no voxel
    covers keep the GL clear depth 1."""
    dev = volume.data.device
    w, h = config.width, config.height
    n_pix = w * h
    pix, valid, z, _ = _pixels(_ndc(volume, camera), config)
    inf = torch.full_like(z, float("inf"))
    zmin = _segment_min(torch.where(valid, z, inf), pix, n_pix + SENTINELS,
                        float("inf"))[:n_pix]
    depth = torch.where(torch.isfinite(zmin), (zmin + 1.0) * 0.5,
                        torch.ones((), dtype=_f32, device=dev))
    d = depth[:, None]
    img = torch.cat([d, d, d, torch.ones_like(d)], dim=-1)
    return img.reshape(w, h, 4)


def render_depth_vrc(volume: Volume, tf: TransferFunction, camera: Camera,
                     config: RenderConfig) -> torch.Tensor:
    """Ray-cast depth map -> [W, H, 4] grey (the z-buffer idea applied to
    the a1 ray caster): per pixel the opacity-weighted expected sample
    depth E[t] along the ray, over the viewplane distance, clipped to [0,
    1]; fully transparent rays read 1.  A plain scan over the samples
    (``sampling.octree_nn_sample`` over trunc(cal_max), the TF's alpha),
    on the volume's device."""
    from . import raycast

    dev = volume.data.device
    camera = camera.to(dev)
    origins = raycast.ray_origins(camera, config)
    dirs = raycast.primary_ray_dirs(camera, config)
    ds = torch.tensor(config.sample_distance, dtype=_f32, device=dev)
    clip = torch.tensor(config.front_clip, dtype=_f32, device=dev)
    half = const(0.5, dev)
    vol_flat = _channel0(volume)
    cal_trunc = torch.trunc(volume.cal_max)
    shape = (config.width, config.height, 1)
    c = torch.zeros(shape, dtype=_f32, device=dev)
    t = torch.ones(shape, dtype=_f32, device=dev)
    steps = torch.arange(config.samples_per_ray, dtype=_f32, device=dev)
    for i in range(config.samples_per_ray):
        ti = steps[i] * ds + clip
        p = (origins + ti * dirs) + half
        v = sampling.octree_nn_sample(vol_flat, volume.dims,
                                      volume.octree_depth, p)
        a = tf.classify(v / cal_trunc)[..., 3:4]
        c = c + t * a * ti
        t = t * (1.0 - a)
    vp = torch.tensor(config.viewplane_distance, dtype=_f32, device=dev)
    depth = ((c + t * vp) / vp).clamp(0.0, 1.0)
    return torch.cat([depth, depth, depth, torch.ones_like(depth)], dim=-1)
