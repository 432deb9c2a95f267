"""The fused a5/TEST ray march: its prep, its plain PyTorch version and the
wrapper of its CUDA kernel (``csrc/a5.cu``).

Counterpart of ``volumerenderingproject_tpu/ops/pallas_a5.py`` in its
resident modes (the f32 rows and the 4-bit id grid, unlit or
``baked_light``): camera-grid sample positions through the three stage
matrices, the 8 corners of each sample with float-offset truncation and the
reference's flat-index wrap, each corner classified through the transfer
function, the corner colours mixed y->x->z [-> ``rgb * M + S`` at the
containing voxel], front-to-back (C, T) compositing and early ray
termination.

The a5 pipeline classifies every corner by itself (kernel.cu:129-175), so a
per-voxel **uint8 interval-id grid** (the TF's last-match-wins index of
``v / cal_max``, with the float ``cal_max`` and no negative clamp) gives the
corner colours bit for bit.  A corner at ``flat >= X*Y*Z`` reads intensity
0, whose id is ``id0``; samples outside ``[0, dims)`` take TF(0)'s colour.
Prep (per call, plain PyTorch):

  * :func:`a5_ids`: the id grid and ``id0``;
  * :func:`stage_matrices`: modelCam, inverseView and toVolume, built on
    the camera's device exactly as ``models/raycast._a5_positions`` builds
    them (kernel.cu:1177-1217);
  * :func:`prepare_a5`: the kernel's scalar vector (slots ``S_*``), and
    with lighting the per-voxel Blinn-Phong factors (M, S) of
    ``ops/phong.bake_light_grids``, viewed along ``-camera.front``: the a5
    grid marches along the front for every ray (kernel.cu:1190), so the
    factors are exact for any camera.

The kernel's only skip is early termination: it stops a ray before the
first sample at which T <= eps, which changes the output by at most eps
times the largest colour; :func:`march_a5_plain` stops at the same sample.
``config`` fields the a5 path does not read (kernel.cu:72-187): ``conic``,
``interp``, ``density_scale``, ``tf_lut``, ``front_clip`` and
``empty_space_skipping``; its rays start on the screen plane and step by
``viewplane_distance / samples_per_ray`` along the camera's front.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import transforms as T
from ..utils.config import RenderConfig
from . import _build
from .phong import (Light, bake_light_grids, check_uniform_light,
                    default_light, is_lit)
from .sampling import corner_flat_indices, trilinear_mix_colors

_f32 = torch.float32
MAX_INTERVALS = 256  # ids are uint8; the kernel keeps the colours in shared memory

# slots of the kernel's scalar vector: the three stage matrices as 3x4 rows
# (modelCam, inverseView, toVolume), eps, id0 and the background
S_MC, S_IV, S_TV, S_EPS, S_ID0, S_BG = 0, 12, 24, 36, 37, 38
SCAL_LEN = 41

# launches of the CUDA kernel since import (or since a caller reset them),
# in all and by variant
launches = 0
variant_launches = {"unlit": 0, "baked": 0}


class A5Args(NamedTuple):
    """Everything one a5 march needs, on one device."""

    scal: torch.Tensor  # [41] f32
    colors: torch.Tensor  # [K, 4] f32
    ids: torch.Tensor  # [X, Y, Z] uint8
    dims: Tuple[int, int, int]
    width: int
    height: int
    spr: int
    mgrid: Optional[torch.Tensor] = None  # [X, Y, Z] f32 baked M, lit only
    sgrid: Optional[torch.Tensor] = None  # [X, Y, Z] f32 baked S, lit only


def check_supported(config: RenderConfig, channels: int) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item (queue 1), for
    what this slice's a5 path does not render yet."""
    if config.scattering:
        raise NotImplementedError(
            "scattered a5 renders are not ported yet: ROADMAP.md item 9 "
            "(lighting, LUT and scattering: henyey_greenstein, "
            "light_transmittance_grid, bake_scatter_grid)")
    if channels != 1:
        raise NotImplementedError(
            "multichannel volumes are not ported yet: ROADMAP.md item 10 "
            "(multichannel)")


def a5_ids(volume, tf) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids uint8 [X, Y, Z], id0 int64 scalar): the TF interval index of
    every voxel under a5 value semantics (``v / cal_max`` with the float
    header value and no negative clamp; PARITY C4), and the index of
    intensity 0.  ``cal_max`` stays a device tensor: CUDA divides by a host
    scalar as a product with its reciprocal."""
    k = tf.num_intervals
    if k > MAX_INTERVALS:
        raise ValueError(f"the id grid holds at most {MAX_INTERVALS} "
                         f"intervals, got {k}")
    cal = volume.cal_max.to(device=volume.data.device, dtype=_f32)
    ids = tf.classify_index(volume.data / cal)
    id0 = tf.classify_index(torch.zeros((), dtype=_f32,
                                        device=volume.data.device))
    return ids.to(torch.uint8), id0


def stage_matrices(camera, dims: Tuple[int, int, int], config: RenderConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(modelCam, inverseView, toVolume), each [4, 4] f32 on the camera's
    device (kernel.cu:1177-1217).  The host-side scalars are Python doubles
    rounded once to float32, as the JAX package rounds them."""
    dev = camera.device
    model_cam = T.scale(
        T.translate(T.identity(dev), (-config.real_screen_width / 2.0,
                                      -config.real_screen_height / 2.0, 0.0)),
        (config.real_screen_width / config.width,
         config.real_screen_height / config.height,
         -config.viewplane_distance / config.samples_per_ray))
    inverse_view = T.inverse(camera.look_at_origin_view())
    L = float(max(dims))
    to_volume = T.matmul(
        T.matmul(T.translation([d / 2.0 - L / 2.0 for d in dims], dev),
                 T.scaling((L, L, L), dev)),
        T.translation((0.5, 0.5, 0.5), dev))
    return model_cam, inverse_view, to_volume


def apply_stages(mats, x: torch.Tensor, y: torch.Tensor, i: torch.Tensor
                 ) -> torch.Tensor:
    """Voxel-space positions (..., 3) of camera-grid points (x, y, i): the
    three stage matrices (3x4 or 4x4) applied in sequence, each in
    ``T.apply``'s order ((p0 r0 + p1 r1) + p2 r2) + t (kernel.cu:100-115)."""
    pos = torch.stack([x, y, i.to(_f32).expand(x.shape)], dim=-1)
    for m in mats:
        pos = T.apply(m, pos)
    return pos


def prepare_a5(volume, tf, camera, config: RenderConfig,
               early_eps: float, light: Light | None = None) -> A5Args:
    """Prep for one a5 march; all tensors on the volume's device.
    ``light`` defaults to :func:`ops.phong.default_light` where the render
    is lit."""
    check_supported(config, volume.channels)
    check_uniform_light(light)
    dev = volume.data.device
    tf = tf.to(dev)
    camera = camera.to(dev)
    ids, id0 = a5_ids(volume, tf)
    mats = stage_matrices(camera, volume.dims, config)
    scal = torch.cat([m[:3].reshape(-1) for m in mats] + [
        torch.tensor([early_eps], dtype=_f32, device=dev),
        id0.to(_f32).reshape(1),
        torch.tensor(list(config.background[:3]), dtype=_f32, device=dev),
    ])
    mgrid = sgrid = None
    if is_lit(config, light):
        lg = default_light(dev) if light is None else light.to(dev)
        mgrid, sgrid = bake_light_grids(volume.data, config, lg,
                                        -camera.front)
    return A5Args(scal=scal, colors=tf.colors.to(_f32).contiguous(), ids=ids,
                  dims=volume.dims, width=config.width, height=config.height,
                  spr=config.samples_per_ray, mgrid=mgrid, sgrid=sgrid)


def _stage_rows(a: A5Args):
    return [a.scal[s:s + 12].reshape(3, 4) for s in (S_MC, S_IV, S_TV)]


def _corners(a: A5Args):
    """``corners(i) -> (ids int64 [W, H, 8], frac [W, H, 3], inside bool
    [W, H], flat0 int64 [W, H])``: every ray's sample i through the stage
    matrices, its 8 corner ids in fetch order (a corner at ``flat >=
    total`` takes ``id0``), its trilinear fractions, and the flat index of
    its containing voxel (the first corner; in range where inside)."""
    dev = a.ids.device
    w, h = a.width, a.height
    x = torch.arange(w, dtype=_f32, device=dev)[:, None].expand(w, h)
    y = torch.arange(h, dtype=_f32, device=dev)[None, :].expand(w, h)
    mats = _stage_rows(a)
    total = a.ids.numel()
    dimv = torch.tensor(a.dims, dtype=_f32, device=dev)
    ids_flat = a.ids.reshape(-1)
    id0 = a.scal[S_ID0].to(torch.int64)

    def corners(i: int):
        pos = apply_stages(mats, x, y, torch.tensor(float(i), dtype=_f32,
                                                    device=dev))
        inside = ((pos >= 0.0) & (pos < dimv)).all(dim=-1)
        flat = corner_flat_indices(a.dims, pos)
        ok = (flat < total) & inside[..., None]
        mid = torch.where(ok, ids_flat[flat.clamp(0, total - 1)].to(
            torch.int64), id0)
        return mid, pos - torch.trunc(pos), inside, flat[..., 0]

    return corners


def march_a5_plain(a: A5Args, stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> [W, H, 4]: the same function
    with the same float order, unlit or baked, as a loop over samples
    vectorised over rays, stopping each ray where the kernel does.

    With ``stats``, ``stats["samples"]`` is set to the number of samples
    this input needs: those inside the volume on rays not yet terminated.
    """
    dev = a.ids.device
    s = a.scal
    w, h = a.width, a.height
    corners = _corners(a)
    id0 = s[S_ID0].to(torch.int64)
    eps = s[S_EPS].clamp_min(0.0)
    baked = a.mgrid is not None
    if baked:
        total = a.ids.numel()
        mflat, sflat = a.mgrid.reshape(-1), a.sgrid.reshape(-1)
        one = torch.ones((), dtype=_f32, device=dev)
        zero = torch.zeros((), dtype=_f32, device=dev)
    c = torch.zeros((w, h, 3), dtype=_f32, device=dev)
    t = torch.ones((w, h, 1), dtype=_f32, device=dev)
    needed = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(a.spr):
        active = t > eps
        mid, frac, inside, flat0 = corners(i)
        rgba = torch.where(inside[..., None],
                           trilinear_mix_colors(a.colors[mid], frac),
                           a.colors[id0])
        alpha = rgba[..., 3:4]
        rgb = rgba[..., :3]
        if baked:  # rgb * M + S; outside the volume M = 1, S = 0
            f0 = flat0.clamp(0, total - 1)
            m = torch.where(inside, mflat[f0], one)[..., None]
            sh = torch.where(inside, sflat[f0], zero)[..., None]
            rgb = rgb * m + sh
        c = torch.where(active, c + (t * alpha) * rgb, c)
        if stats is not None:
            needed += (inside & active[..., 0]).sum()
        t = torch.where(active, t * (1.0 - alpha), t)
    if stats is not None:
        stats["samples"] = int(needed)
    rgb = c + t * s[S_BG:S_BG + 3]
    return torch.cat([rgb, torch.ones((w, h, 1), dtype=_f32, device=dev)],
                     dim=-1)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("a5")
    fn = lib.vrp_march_a5
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, d1, d2, d3, width, height, spr, mgrid,
        # sgrid, out, stream
        fn.argtypes = [p, p, i, p] + [i] * 6 + [p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def check_kernel_args(a: A5Args, max_intervals: int, extra=()) -> None:
    """Raise ValueError unless ``a`` (and the named ``extra`` tensors) are
    what the a5 kernels take: contiguous, of their type, on one CUDA
    device, of their shapes."""
    dev = a.ids.device
    if dev.type != "cuda":
        raise ValueError(f"the a5 kernels need CUDA tensors, got {dev}")
    for name, t, dtype, shape in (
            ("scal", a.scal, _f32, (SCAL_LEN,)),
            ("colors", a.colors, _f32, None),
            ("ids", a.ids, torch.uint8, a.dims)) + tuple(extra):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(t.shape)}")
    k = a.colors.shape[0]
    if not 0 < k <= max_intervals or a.colors.shape[1] != 4:
        raise ValueError(f"colors must be [K <= {max_intervals}, 4]")


def march_a5_kernel(a: A5Args) -> torch.Tensor:
    """Launch ``csrc/a5.cu`` on the current stream -> [W, H, 4]; the baked
    variant when the args carry (M, S) grids."""
    global launches
    baked = a.mgrid is not None
    if baked != (a.sgrid is not None):
        raise ValueError("mgrid and sgrid go together")
    check_kernel_args(a, MAX_INTERVALS, (
        ("mgrid", a.mgrid, _f32, a.dims),
        ("sgrid", a.sgrid, _f32, a.dims)) if baked else ())
    dev = a.ids.device
    lib = _kernel_lib()
    out = torch.empty((a.width, a.height, 4), dtype=_f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vrp_march_a5(
            a.scal.data_ptr(), a.colors.data_ptr(), a.colors.shape[0],
            a.ids.data_ptr(), *a.dims, a.width, a.height, a.spr,
            a.mgrid.data_ptr() if baked else None,
            a.sgrid.data_ptr() if baked else None, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"a5 march kernel launch failed: CUDA error {err}")
    launches += 1
    variant_launches["baked" if baked else "unlit"] += 1
    return out


def render_test_fused(volume, tf, camera, config: RenderConfig,
                      early_eps: float | None = None,
                      light: Light | None = None) -> torch.Tensor:
    """a5/TEST render through the fused march -> [W, H, 4] (alpha 1).

    CUDA tensors launch the kernel; CPU tensors run :func:`march_a5_plain`.
    ``early_eps`` defaults to ``config.early_termination``.
    """
    eps = config.early_termination if early_eps is None else early_eps
    a = prepare_a5(volume, tf, camera, config, eps, light)
    if a.ids.is_cuda:
        return march_a5_kernel(a)
    return march_a5_plain(a)
