"""The fused a5/TEST ray march: its prep, its plain PyTorch version and the
wrapper of its CUDA kernel (``csrc/a5.cu``).

Counterpart of ``volumerenderingproject_tpu/ops/pallas_a5.py`` in its
resident modes (the f32 rows and the 4-bit id grid, unlit or
``baked_light``, which also carries single scattering) and its streamed
ones (the id grid stays in device memory at every size): camera-grid sample positions through the three stage
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
    factors are exact for any camera.  With scattering S gains
    ``ops/phong.bake_scatter_grid`` along ``camera.front``, its material
    lookup over the float cal_max and its transmittance's alpha over
    trunc(cal_max) (PARITY C4; pallas_a5.py:981-994).

The kernel stops a ray before the first sample at which |T| <= eps, which
changes the output by at most eps times the largest colour (a sample of
alpha above 1 makes T negative, and the ray goes on); :func:`march_a5_plain`
stops at the same sample.  It runs the position chain only on each ray's
span (:func:`sample_range`, the samples whose position may lie in [0,
dims)); every other sample is TF(0)'s colour, skipped where its alpha is 0
and composited as it is otherwise, which leaves the march bit-exact to
:func:`march_a5_plain`.  The position is the TPU kernel's hoisted chain
(:func:`ray_q`, :func:`positions`), bit-equal to :func:`apply_stages` on
the matrices :func:`stage_matrices` builds.
A sharded render (``parallel/render_dist.py``) marches one work unit per
rank on the rays and samples axes (pallas_a5.py:851 with ``segment=True``):
columns [x_offset, x_offset + local_width) and samples [s_start, s_start +
s_count), returning the raw (C, T) pair without the background.  The camera
grid is indexed by the global column (pallas_a5.py:172-178) and the stage
matrices by the global sample index (:212), so a unit's samples sit where
the whole render puts them.  a5 on the volume axis is no kernel path in the
JAX package either (render_dist.py:95).

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
from .march import bake_grids
from .phong import Light, check_uniform_light
from .sampling import corner_flat_indices, trilinear_mix_colors

_f32 = torch.float32
MAX_INTERVALS = 256  # ids are uint8; the kernel keeps the colours in shared memory

# slots of the kernel's scalar vector: the three stage matrices as 3x4 rows
# (modelCam, inverseView, toVolume), eps, id0 and the background
S_MC, S_IV, S_TV, S_EPS, S_ID0, S_BG = 0, 12, 24, 36, 37, 38
SCAL_LEN = 41

# each ray's span is widened by this times the largest magnitude its chain
# adds (csrc/a5_common.cuh kRangePad); a step component at most TINY_STEP
# is not divided by (kTinyStep)
RANGE_PAD = 2.0 ** -14
TINY_STEP = 1e-20

# launches of the CUDA kernel since import (or since a caller reset them),
# in all and by variant
launches = 0
variant_launches = {"unlit": 0, "baked": 0}
# and the launches that marched a sharded render's work unit
segment_launches = 0


class A5Args(NamedTuple):
    """Everything one a5 march needs, on one device."""

    scal: torch.Tensor  # [41] f32
    colors: torch.Tensor  # [K, 4] f32
    ids: torch.Tensor  # [X, Y, Z] uint8
    dims: Tuple[int, int, int]
    width: int
    height: int
    spr: int
    # [X, Y, Z] f32 baked M and S, lit or scattered only
    mgrid: Optional[torch.Tensor] = None
    sgrid: Optional[torch.Tensor] = None
    # a sharded render's work unit: columns [x_offset, x_offset + width),
    # samples [s_start, s_start + spr); ``segment`` returns (C, T) without
    # the background
    x_offset: int = 0
    s_start: int = 0
    segment: bool = False


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


def ray_q(a: A5Args) -> torch.Tensor:
    """[W, H, 3] f32: the i-independent part of every ray's position chain
    (``a5_ray_q`` in csrc/a5_common.cuh, pallas_a5.py:186-188), ``q_c = (px
    s1 + o1) iv[c][0] + (py s2 + o2) iv[c][1]`` for the global columns
    [x_offset, x_offset + width), read from the stage-matrix slots."""
    s = a.scal
    dev = s.device
    x = torch.arange(a.width, dtype=_f32, device=dev) + float(a.x_offset)
    y = torch.arange(a.height, dtype=_f32, device=dev)
    p1x = (x * s[S_MC] + s[S_MC + 3])[:, None]
    p1y = (y * s[S_MC + 5] + s[S_MC + 7])[None, :]
    return torch.stack([p1x * s[S_IV + 4 * c] + p1y * s[S_IV + 4 * c + 1]
                        for c in range(3)], dim=-1)


def _chain_consts(scal: torch.Tensor):
    """(s3, iv[:, 2], iv[:, 3], L, m3) of the scalar vector, as
    ``a5_chain`` reads them: [1] and four [3]."""
    c = torch.arange(3, device=scal.device)
    return (scal[S_MC + 10], scal[S_IV + 4 * c + 2], scal[S_IV + 4 * c + 3],
            scal[S_TV + 5 * c], scal[S_TV + 4 * c + 3])


def positions(a: A5Args, q: torch.Tensor, i: int) -> torch.Tensor:
    """[W, H, 3] f32: sample i's voxel-space position on every ray through
    the hoisted chain (``a5_position``): ``p2_c = (q_c + (i s3) iv[c][2]) +
    iv[c][3]``, ``p_c = p2_c L_c + m3_c``, 16 operations."""
    s3, iv2, iv3, L, m3 = _chain_consts(a.scal)
    p1z = torch.tensor(float(i), dtype=_f32, device=q.device) * s3
    return ((q + p1z * iv2) + iv3) * L + m3


def sample_range(a: A5Args) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each ray's span of samples as the a5 kernels take it (``a5_span`` in
    csrc/a5_common.cuh, in its float order) -> (lo, hi) int64 [W, H],
    within the unit's samples [s_start, s_start + spr); an empty span is
    (end, end - 1), end = s_start + spr.  Every sample whose chain puts it
    in [0, dims) lies in it.  Used to check and count the spans:
    :func:`march_a5_plain` evaluates every sample."""
    s3, iv2, iv3, L, m3 = _chain_consts(a.scal)
    q = ray_q(a)
    dev = q.device
    end = a.s_start + a.spr
    imax = torch.tensor(float(end), dtype=_f32, device=dev)
    A = (q + iv3) * L + m3
    B = (s3 * iv2) * L
    mag = (((q.abs() + (s3 * iv2).abs() * imax) + iv3.abs()) * L.abs()
           + m3.abs())
    finite = (torch.isfinite(A).all(-1) & bool(torch.isfinite(B).all())
              & torch.isfinite(mag).all(-1))
    pad = RANGE_PAD * (mag + 2.0)
    lo_b = 0.0 - pad
    hi_b = torch.tensor(a.dims, dtype=_f32, device=dev) + pad
    safe = B.abs() > TINY_STEP
    bv = torch.where(safe, B, torch.ones_like(B))
    ta = (lo_b - A) / bv
    tb = (hi_b - A) / bv
    in_c = (A >= lo_b) & (A <= hi_b)
    inf = torch.full_like(A, float("inf"))
    lo_c = torch.where(safe, torch.fmin(ta, tb), torch.where(in_c, -inf, inf))
    hi_c = torch.where(safe, torch.fmax(ta, tb), torch.where(in_c, inf, -inf))
    t_lo, t_hi = -inf[..., 0], inf[..., 0]
    for c in range(3):  # fmaxf / fminf: a NaN operand gives the other
        t_lo = torch.fmax(t_lo, lo_c[..., c])
        t_hi = torch.fmin(t_hi, hi_c[..., c])
    w_lo = torch.tensor(float(a.s_start), dtype=_f32, device=dev) - 2.0
    w_hi = imax + 1.0

    def clamped(v):
        return torch.fmin(torch.fmax(v, w_lo), w_hi)

    lo = torch.clamp(torch.floor(clamped(t_lo)).to(torch.int64) - 1,
                     min=a.s_start)
    hi = torch.clamp(torch.ceil(clamped(t_hi)).to(torch.int64) + 1,
                     max=end - 1)
    empty = ~(t_hi >= t_lo) | (lo > hi)
    lo = torch.where(finite, torch.where(empty, end, lo), a.s_start)
    hi = torch.where(finite, torch.where(empty, end - 1, hi), end - 1)
    return lo, hi


def index32(dims: Tuple[int, int, int]) -> bool:
    """Whether the a5 kernels take 32-bit voxel indices on a grid of
    ``dims`` (``a5_index32`` in csrc/a5_common.cuh): where every flat index
    a corner can form, its indices up to dim + 1 with the row and plane
    wraps, stays below 2^31.  Else 64-bit."""
    d1, d2, d3 = dims
    return (d1 + 1) * d2 * d3 + (d2 + 1) * d3 + (d3 + 1) < 2**31


def scal_vector(camera, dims: Tuple[int, int, int], config: RenderConfig,
                early_eps: float, id0: torch.Tensor) -> torch.Tensor:
    """The kernels' scalar vector [41] f32 on the camera's device: the
    three stage matrices' rows (slots S_MC, S_IV, S_TV), eps, id0 and the
    background."""
    dev = camera.device
    mats = stage_matrices(camera, dims, config)
    return torch.cat([m[:3].reshape(-1) for m in mats] + [
        torch.tensor([early_eps], dtype=_f32, device=dev),
        id0.to(device=dev, dtype=_f32).reshape(1),
        torch.tensor(list(config.background[:3]), dtype=_f32, device=dev),
    ])


def check_fused_supported(channels: int, light: Light | None = None) -> None:
    """Raise NotImplementedError, naming ``mode='scan'``, for an a5 render
    the fused march does not compute: a 4-D volume (the JAX package's a5
    kernel rejects it, pallas_a5.py:914-915, and its scan renders it) and
    a light colour that is not uniform (the bake folds one colour)."""
    if channels != 1:
        raise NotImplementedError(
            "the fused a5 march reads one channel, as the JAX package's a5 "
            "kernel does (pallas_a5.py:914-915); mode='scan' renders a 4-D "
            "volume as the JAX scan reads it")
    check_uniform_light(light)


def prepare_a5(volume, tf, camera, config: RenderConfig,
               early_eps: float, light: Light | None = None, *,
               x_offset: int = 0, local_width: int | None = None,
               s_start: int = 0, s_count: int | None = None,
               segment: bool = False) -> A5Args:
    """Prep for one a5 march; all tensors on the volume's device.
    ``light`` defaults to :func:`ops.phong.default_light` where the render
    is lit or scattered.  A 4-D volume raises: the JAX package's a5 kernel
    rejects it (pallas_a5.py:914-915) and its scan renders it.  The
    keywords select a sharded render's work unit (this module's
    docstring); ``segment`` marches to (C, T)."""
    check_fused_supported(volume.channels, light)
    w_local = config.width if local_width is None else local_width
    s_count = config.samples_per_ray if s_count is None else s_count
    if not (0 <= x_offset and 0 < w_local and x_offset + w_local <= config.width
            and 0 <= s_start and 0 < s_count
            and s_start + s_count <= config.samples_per_ray):
        raise ValueError(
            f"columns [{x_offset}, {x_offset + w_local}) or samples "
            f"[{s_start}, {s_start + s_count}) outside the image's "
            f"{config.width} and {config.samples_per_ray}")
    dev = volume.data.device
    tf = tf.to(dev)
    camera = camera.to(dev)
    ids, id0 = a5_ids(volume, tf)
    scal = scal_vector(camera, volume.dims, config, early_eps, id0)
    cal = volume.cal_max.to(device=dev, dtype=_f32)
    mgrid, sgrid = bake_grids(volume, tf, camera, config, light, cal,
                              torch.trunc(cal))
    return A5Args(scal=scal, colors=tf.colors.to(_f32).contiguous(), ids=ids,
                  dims=volume.dims, width=w_local, height=config.height,
                  spr=s_count, mgrid=mgrid, sgrid=sgrid, x_offset=x_offset,
                  s_start=s_start, segment=segment)


def _stage_rows(a: A5Args):
    return [a.scal[s:s + 12].reshape(3, 4) for s in (S_MC, S_IV, S_TV)]


def _corners(a: A5Args):
    """``corners(i) -> (ids int64 [W, H, 8], frac [W, H, 3], inside bool
    [W, H], flat0 int64 [W, H])``: every ray's sample i through the stage
    matrices, its 8 corner ids in fetch order (a corner at ``flat >=
    total`` takes ``id0``), its trilinear fractions, and the flat index of
    its containing voxel (the first corner; in range where inside).  The
    rays are those of the global columns [x_offset, x_offset + width)."""
    dev = a.ids.device
    w, h = a.width, a.height
    x = (torch.arange(w, dtype=_f32, device=dev)
         + float(a.x_offset))[:, None].expand(w, h)
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


def march_a5_plain(a: A5Args, stats: dict | None = None):
    """Plain PyTorch version of the kernel -> [W, H, 4], or with
    ``a.segment`` the (C [W, H, 3], T [W, H, 1]) pair: the same function
    with the same float order, unlit or baked, over a work unit's columns
    and samples, as a loop over samples vectorised over rays, stopping each
    ray where the kernel does.

    With ``stats``, ``stats["samples"]`` is set to the number of samples
    this input needs: those inside the volume on rays not yet terminated,
    and ``stats["outside"]`` to those outside it on such rays (TF(0)'s
    colour, composited where its alpha is not 0).
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
    outside = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(a.s_start, a.s_start + a.spr):
        active = t.abs() > eps
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
            outside += (~inside & active[..., 0]).sum()
        t = torch.where(active, t * (1.0 - alpha), t)
    if stats is not None:
        stats["samples"] = int(needed)
        stats["outside"] = int(outside)
    if a.segment:
        return c, t
    rgb = c + t * s[S_BG:S_BG + 3]
    return torch.cat([rgb, torch.ones((w, h, 1), dtype=_f32, device=dev)],
                     dim=-1)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("a5")
    fn = lib.vrp_march_a5
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, d1, d2, d3, width, height, spr, mgrid,
        # sgrid, x_offset, s_start, segment, out, stream
        fn.argtypes = [p, p, i, p] + [i] * 6 + [p, p, i, i, i, p, p]
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


def march_a5_kernel(a: A5Args):
    """Launch ``csrc/a5.cu`` on the current stream -> [W, H, 4], or with
    ``a.segment`` the (C [W, H, 3], T [W, H, 1]) pair of a work unit; the
    baked variant when the args carry (M, S) grids."""
    global launches, segment_launches
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
            a.sgrid.data_ptr() if baked else None, a.x_offset, a.s_start,
            int(a.segment), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"a5 march kernel launch failed: CUDA error {err}")
    launches += 1
    variant_launches["baked" if baked else "unlit"] += 1
    if a.segment:
        segment_launches += 1
        return out[..., :3], out[..., 3:]
    return out


def render_test_fused(volume, tf, camera, config: RenderConfig,
                      early_eps: float | None = None,
                      light: Light | None = None, **unit):
    """a5/TEST render through the fused march -> [W, H, 4] (alpha 1), or a
    sharded render's work unit (pallas_a5.py:851, ``segment=True``) with
    ``unit``, the keywords of :func:`prepare_a5`: with ``segment=True`` the
    (C [w, H, 3], T [w, H, 1]) pair of its columns and samples.

    CUDA tensors launch the kernel; CPU tensors run :func:`march_a5_plain`.
    ``early_eps`` defaults to ``config.early_termination``.
    """
    eps = config.early_termination if early_eps is None else early_eps
    a = prepare_a5(volume, tf, camera, config, eps, light, **unit)
    if a.ids.is_cuda:
        return march_a5_kernel(a)
    return march_a5_plain(a)
