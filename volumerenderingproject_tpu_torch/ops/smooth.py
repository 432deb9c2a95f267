"""The smooth-mode a1 march (``Interp.TRILINEAR``): its prep, its plain
PyTorch version and the wrapper of its CUDA kernel (``csrc/smooth.cu``,
K8).

Counterpart of the forward half of
``volumerenderingproject_tpu/ops/pallas_smooth.py``: ``_ray_setup``,
``_sample_smooth`` and ``_smooth_fwd_kernel`` (pallas_smooth.py:64-346),
the scalar vector and the image of ``render_vrc_smooth_pallas``
(pallas_smooth.py:724-904).  Per sample:

    vox  = ((o + ti d) + 0.5) L + (dims/2 - L/2)      ti = float(i) ds + clip
    v    = zero-padded trilinear intensity at vox     (z, then y, then x)
    vn   = v / cal_max                                (the float header value)
    w_k  = sig(s (vn - lo_k)) sig(s (hi_k - vn)),  k = 1..K-1
    rgba = c_0 + w_1 (c_1 - c_0) + w_2 (c_2 - c_0) + ...
    C += (T a) rgb,  T *= 1 - a;   image = (C + T bg, 1)

Every sample composites: off the volume a sample reads intensity 0, whose
smooth alpha is not 0, so no sample is skipped.  Its RGBA is then the
constant classify(0 / cal_max), so the kernels evaluate only the samples
of each ray's range (:func:`sample_range`, the box on which a corner can
lie in the volume) and give the rest that constant, which is exact.  A
ray stops before the first sample at which |T| <= eps.  The volume is one
contiguous f32 [X, Y, Z] tensor at every size: the TPU kernel's f32 rows
(z <= 128) and its 10-bit packed grid were VMEM layouts and are not
ported.

The fused march computes the plain smooth classify only, as the JAX
package's ``smooth_pallas_eligible`` says: no lighting, scattering or LUT,
``density_scale`` 1, at most 16 intervals, one channel.  The rest renders
in ``mode="scan"`` (:func:`check_smooth_supported`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..scene.transfer_function import sigmoid
from ..utils.config import Interp, RenderConfig
from . import _build, march
from .phong import is_lit
from .sampling import trilinear_intensity_sample

_f32 = torch.float32
MAX_INTERVALS = 16  # the JAX kernels' limit (pallas_smooth.py:716)

# slots of the kernel's scalar vector; ds, clip, eps and the camera slots
# are ops/march.py's (the kernels share ray_setup, csrc/march_common.cuh)
S_DS, S_CLIP, S_CAL_MAX, S_EPS, S_SHARP = 0, 1, 2, 3, 4
S_VOFF, S_L, S_BG = 22, 25, 26
SCAL_LEN = 29

# launches of the CUDA kernel since import (or since a caller reset it)
launches = 0


class SmoothArgs(NamedTuple):
    """Everything one smooth march needs, on one device."""

    scal: torch.Tensor  # [29] f32
    lower: torch.Tensor  # [K] f32
    upper: torch.Tensor  # [K] f32
    colors: torch.Tensor  # [K, 4] f32
    data: torch.Tensor  # [X, Y, Z] f32, contiguous
    dims: Tuple[int, int, int]
    width: int
    height: int
    spr: int
    conic: bool


def check_smooth_supported(config: RenderConfig, num_intervals: int,
                           light=None, channels: int = 1) -> None:
    """Raise NotImplementedError, naming ``mode='scan'``, for a smooth
    render or fit the fused marches do not compute (the exclusions of
    ``smooth_pallas_eligible``, pallas_smooth.py:706-721): a 4-D volume
    (the JAX package's smooth kernel takes one channel, pallas_smooth.py:
    712), lighting, scattering, a LUT, ``density_scale != 1`` and more
    than 16 intervals; ``mode="scan"`` renders and fits each of them.  A
    config that is not smooth is a ValueError."""
    if config.interp is not Interp.TRILINEAR:
        raise ValueError("the smooth march samples Interp.TRILINEAR only")
    if channels != 1:
        raise NotImplementedError(
            "the smooth march samples one channel, as the JAX package's "
            "smooth kernel does; mode='scan' renders a 4-D volume (by "
            "nearest voxel, as the JAX scan does whatever config.interp "
            "says)")
    what = None
    if is_lit(config, light):
        what = "lighting"
    elif config.scattering:
        what = "scattering"
    elif config.tf_lut:
        what = "tf_lut"
    elif config.density_scale != 1.0:
        what = "density_scale != 1"
    elif num_intervals > MAX_INTERVALS:
        what = f"more than {MAX_INTERVALS} intervals ({num_intervals})"
    if what is not None:
        raise NotImplementedError(
            f"the fused smooth march (K8) computes the plain smooth classify; "
            f"{what} is not in it, as in the JAX package's kernel: ROADMAP.md "
            f"item 12 (smooth mode); mode='scan' renders and fits it")


def scal_vector(camera, config: RenderConfig, dims, cal_max: torch.Tensor,
                early_eps: float) -> torch.Tensor:
    """The kernel's [29] f32 scalar vector (slots ``S_*`` above and
    ``march.S_POS`` .. ``march.S_RSH``), built on the camera's device:
    the conic-corrected top-left, ``voff = dims/2 - L/2``, ``L``, the float
    ``cal_max``, the sharpness and the background."""
    dev = camera.device
    top_left = camera.top_left
    if config.conic and config.conic_corrected:
        top_left = top_left + torch.tensor(
            config.viewplane_distance, dtype=_f32, device=dev) * camera.front
    L = float(max(dims))
    voff = [d / 2.0 - L / 2.0 for d in dims]  # exact halves

    def host(vals):
        return torch.tensor(vals, dtype=_f32, device=dev)

    return torch.cat([
        host([config.sample_distance, config.front_clip]),
        cal_max.to(_f32).reshape(1),
        host([early_eps, config.tf_sharpness]),
        camera.position, camera.front, camera.right, camera.up, top_left,
        host([config.real_screen_width, config.real_screen_height]
             + voff + [L] + list(config.background[:3])),
    ])


def prepare_smooth(volume, tf, camera, config: RenderConfig,
                   early_eps: float, light=None) -> SmoothArgs:
    """Prep for one smooth march; all tensors on the volume's device (the
    TF's tensors keep any autograd history: the differentiable march
    detaches them itself).  A 4-D volume raises: the JAX package's smooth
    kernel takes one channel (pallas_smooth.py:712) and its scan samples a
    4-D volume by nearest voxel whatever ``config.interp`` says."""
    check_smooth_supported(config, tf.num_intervals, light,
                           volume.channels)
    dev = volume.data.device
    camera = camera.to(dev)
    scal = scal_vector(camera, config, volume.dims,
                       volume.cal_max.to(dev), early_eps)
    return SmoothArgs(
        scal=scal, lower=tf.lower.to(dev, _f32).contiguous(),
        upper=tf.upper.to(dev, _f32).contiguous(),
        colors=tf.colors.to(dev, _f32).contiguous(),
        data=volume.data.to(_f32).contiguous(),
        dims=volume.dims, width=config.width, height=config.height,
        spr=config.samples_per_ray, conic=bool(config.conic))


def _voxel_positions(a: SmoothArgs, o: torch.Tensor, d: torch.Tensor):
    """``vox_at(i) -> [W, H, 3]``: sample i's voxel-space position in the
    kernel's float order."""
    dev = a.scal.device
    s = a.scal
    L = s[S_L]
    voff = s[S_VOFF:S_VOFF + 3]

    def vox_at(i: int) -> torch.Tensor:
        ti = torch.tensor(float(i), dtype=_f32, device=dev) * s[S_DS] + s[S_CLIP]
        return ((o + ti * d) + 0.5) * L + voff

    return vox_at


def smooth_classify(a: SmoothArgs, vn: torch.Tensor):
    """The kernel's smooth classify of ``vn`` [...] -> (rgba [..., 4], s1,
    s2, w [..., K-1]): the sigmoid as ``1 / (1 + exp(-x))`` and the terms
    ``w_k (c_k - c_0)`` added to ``c_0`` in k order."""
    sharp = a.scal[S_SHARP]
    v = vn[..., None]
    s1 = sigmoid(sharp * (v - a.lower[1:]))
    s2 = sigmoid(sharp * (a.upper[1:] - v))
    w = s1 * s2
    dk = a.colors[1:] - a.colors[0]
    rgba = a.colors[0].expand(vn.shape + (4,))
    for k in range(1, a.colors.shape[0]):
        rgba = rgba + w[..., k - 1:k] * dk[k - 1]
    return rgba, s1, s2, w


def sample_fn(a: SmoothArgs):
    """``sample(i) -> (rgba [W, H, 4], s1, s2, w [W, H, K-1], vox [W, H,
    3])``: the kernel's sample chain on every ray."""
    o, d = march._rays(a)
    vox_at = _voxel_positions(a, o, d)
    cal = a.scal[S_CAL_MAX]

    def sample(i: int):
        vox = vox_at(i)
        vn = trilinear_intensity_sample(a.data, vox) / cal
        rgba, s1, s2, w = smooth_classify(a, vn)
        return rgba, s1, s2, w, vox

    return sample


def touches_volume(vox: torch.Tensor, dims) -> torch.Tensor:
    """bool [...]: whether any of the eight corners of positions ``vox``
    (..., 3) lies in the volume."""
    dimv = torch.tensor(dims, dtype=_f32, device=vox.device)
    return ((vox >= -1.0) & (vox < dimv)).all(dim=-1)


def sample_range(a: SmoothArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(i_lo, i_hi), int64 [W, H]: each ray's samples that may have a
    corner in the volume, as the kernels compute them
    (``smooth_sample_range``, csrc/smooth_common.cuh, on ``box_span``), in
    their float order; i_lo > i_hi where there is none.  The kernels give
    every sample outside it the RGBA of intensity 0.  Used to check and
    count that range; the plain versions evaluate every sample."""
    s = a.scal
    o, d = march._rays(a)
    ds, clip, L = s[S_DS], s[S_CLIP], s[S_L]
    voff = s[S_VOFF:S_VOFF + 3]
    dims = torch.tensor(a.dims, dtype=_f32, device=s.device)
    pad = march.span_pad(o, d, ds, clip)
    finite = (pad >= 0.0) & bool(torch.isfinite(L)
                                 and torch.isfinite(voff).all())
    i_lo, i_hi = march.box_span(o, d, (-1.0 - voff) / L - 0.5,
                                (dims - voff) / L - 0.5, pad, ds, clip, False)
    return (torch.where(finite, i_lo.clamp_min(0), 0),
            torch.where(finite, i_hi.clamp_max(a.spr - 1), a.spr - 1))


def march_smooth_plain(a: SmoothArgs, stats: dict | None = None
                       ) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> [W, H, 4]: the same function
    in the same float order, a loop over samples vectorised over rays, in
    O(W*H) memory.  It stops each ray where the kernel does.

    With ``stats``, ``stats["samples"]`` is set to the samples this input
    needs on live rays, and ``stats["inside"]`` to those of them with a
    corner in the volume."""
    dev = a.scal.device
    s = a.scal
    w, h = a.width, a.height
    sample = sample_fn(a)
    eps = s[S_EPS].clamp_min(0.0)
    c = torch.zeros((w, h, 3), dtype=_f32, device=dev)
    t = torch.ones((w, h, 1), dtype=_f32, device=dev)
    live = torch.zeros((), dtype=torch.int64, device=dev)
    inside = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(a.spr):
        active = t.abs() > eps
        rgba, _, _, _, vox = sample(i)
        alpha = rgba[..., 3:4]
        c = torch.where(active, c + (t * alpha) * rgba[..., :3], c)
        t = torch.where(active, t * (1.0 - alpha), t)
        if stats is not None:
            live += active.sum()
            inside += (active[..., 0] & touches_volume(vox, a.dims)).sum()
    if stats is not None:
        stats["samples"] = int(live)
        stats["inside"] = int(inside)
    rgb = c + t * s[S_BG:S_BG + 3]
    return torch.cat([rgb, torch.ones((w, h, 1), dtype=_f32, device=dev)],
                     dim=-1)


def _kernel_lib() -> ctypes.CDLL:
    return bind(_build.load("smooth"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/smooth.cu (this tree's or another
    checkout's, which chip_smoke.py times beside it), with the C signature
    of ``vrp_smooth_fwd`` set."""
    fn = lib.vrp_smooth_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, lower, upper, colors, K, vol, d1, d2, d3, width, height, spr,
        # conic, out, stream
        fn.argtypes = [p, p, p, p, i, p] + [i] * 7 + [p, p]
        fn.restype = ctypes.c_int
    return lib


def check_kernel_args(a: SmoothArgs) -> torch.device:
    """The device of ``a``'s tensors, after checking what the smooth
    kernels take: CUDA, float32, contiguous, shapes that match."""
    dev = a.data.device
    if dev.type != "cuda":
        raise ValueError(f"the smooth kernels need CUDA tensors, got {dev}")
    k = a.colors.shape[0]
    for name, t, shape in (("scal", a.scal, (SCAL_LEN,)),
                           ("lower", a.lower, (k,)),
                           ("upper", a.upper, (k,)),
                           ("colors", a.colors, (k, 4)),
                           ("data", a.data, a.dims)):
        if t.device != dev or t.dtype != _f32 or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(t.shape)}")
    if not 0 < k <= MAX_INTERVALS:
        raise ValueError(f"colors must be [K <= {MAX_INTERVALS}, 4]")
    return dev


def march_smooth_kernel(a: SmoothArgs) -> torch.Tensor:
    """Launch ``csrc/smooth.cu`` on the current stream -> [W, H, 4]."""
    global launches
    dev = check_kernel_args(a)
    lib = _kernel_lib()
    out = torch.empty((a.width, a.height, 4), dtype=_f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.vrp_smooth_fwd(
            a.scal.data_ptr(), a.lower.data_ptr(), a.upper.data_ptr(),
            a.colors.data_ptr(), a.colors.shape[0], a.data.data_ptr(),
            *a.dims, a.width, a.height, a.spr, int(a.conic), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smooth march kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return out


def render_vrc_smooth_fused(volume, tf, camera, config: RenderConfig,
                            early_eps: float | None = None,
                            light=None) -> torch.Tensor:
    """Smooth-mode a1 render through the fused march -> [W, H, 4] (alpha
    1).  CUDA tensors launch the kernel; CPU tensors run
    :func:`march_smooth_plain`.  ``early_eps`` defaults to
    ``config.early_termination``."""
    eps = config.early_termination if early_eps is None else early_eps
    a = prepare_smooth(volume, tf, camera, config, eps, light)
    if a.data.is_cuda:
        return march_smooth_kernel(a)
    return march_smooth_plain(a)

