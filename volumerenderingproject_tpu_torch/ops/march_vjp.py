"""The differentiable a1 march: the backward march's plain PyTorch version,
the wrapper of its CUDA kernel (``csrc/march_bwd.cu``), the autograd
function that pairs it with the forward march (``ops/march.py``), and the
differentiable render.

Counterpart of ``volumerenderingproject_tpu/ops/pallas_march_vjp.py`` on the
plain a1 path: ``_march_bwd_kernel`` without baked light, LUT, slab or
multichannel, the ``_make_core`` custom VJP, and
``render_vrc_pallas_diff``.

Backward math (front-to-back over in (C, T) form, output alpha 1):

    forward:  w_s = T_s a_s,  C += w_s c_s,  T_{s+1} = T_s (1 - a_s)
    output:   rgb = C + T_N * bg

With the per-ray cotangents g (of rgb) and g_t (of T_N, through + T_N*bg):

    dL/dc_s = g * w_s
    dL/da_s = T_s (g . c_s) - (S_{>s} + T_N g_t) / (1 - a_s)
    S_{>s}  = sum_{j>s} w_j (g . c_j)

in two passes per ray: pass A sums total = sum_j w_j (g . c_j) and T_N;
pass B marches again keeping the prefix P_s in pass A's float order, so
S_{>s} = total - P_s.  Where 1 - a_s == 0 the division term is gated to 0,
as in the TPU kernel (the true limit would need a third pass).  The
backward marches every sample: a sample of alpha 0 still has an alpha
gradient, so the forward's skips do not apply.  Each sample's terms go to
the interval of its id; samples off the volume go to ``id0``.

The forward runs at ``early_eps = 0`` with ``density_scale`` folded into the
alpha column (its clip included), so the march runs with density 1 and the
chain rule through the fold reaches the raw colours.  Only the colours get
a gradient: ids, bricks and scalars are built under ``no_grad``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..scene.transfer_function import TransferFunction
from ..utils.config import Interp, RenderConfig
from ..utils.device import resolve_device
from . import _build, march
from .march import S_BG, SCAL_LEN, MarchArgs

_f32 = torch.float32
MAX_INTERVALS = 16  # the JAX kernel's limit (pallas_march_vjp.py:1538)
BLOCK = 16  # pixels per edge of the kernel's blocks; one partial per block

# launches of the CUDA kernel since import (or since a caller reset it)
launches = 0


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: at a bound each side of the
    tie takes half (``torch.clamp`` would pass all of it)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def check_diff_supported(config: RenderConfig, channels: int,
                         num_intervals: int) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for what the
    differentiable march of this slice does not compute."""
    march.check_supported(config, channels)
    if config.interp is Interp.TRILINEAR:
        raise NotImplementedError(
            "the differentiable nearest-voxel march (K4) does not sample "
            "Interp.TRILINEAR: smooth renders differentiate through "
            "ops/smooth_vjp.render_vrc_smooth_diff (ROADMAP.md item 12, "
            "smooth mode)")
    if config.lighting or config.tf_lut:
        raise NotImplementedError(
            "lit and LUT fits are not ported yet: ROADMAP.md item 9 "
            "(lighting, LUT and scattering) and item 11 (K4's baked-light "
            "and LUT variants)")
    if num_intervals > MAX_INTERVALS:
        raise NotImplementedError(
            f"the differentiable march takes at most {MAX_INTERVALS} TF "
            f"intervals, got {num_intervals}: ROADMAP.md item 11 (K4 "
            "variants)")


def diff_eligible(volume, tf: TransferFunction, config: RenderConfig) -> bool:
    """True when :func:`render_vrc_diff` computes this render
    (cf. ``diff_pallas_eligible``): plain a1 classify, one channel,
    nearest-voxel sampling, at most 16 intervals."""
    try:
        check_diff_supported(config, volume.channels, tf.num_intervals)
    except NotImplementedError:
        return False
    return True


def prepare_diff(volume, tf: TransferFunction, camera, config: RenderConfig
                 ) -> Tuple[MarchArgs, torch.Tensor]:
    """(march args at eps 0 and density 1, the colours with the static
    ``density_scale`` folded into alpha).  The colours keep their autograd
    history; the args are built from a detached copy."""
    check_diff_supported(config, volume.channels, tf.num_intervals)
    colors = tf.colors.to(volume.data.device)
    if config.density_scale != 1.0:
        # pallas_march_vjp.py:1682-1687: a_k -> clip(a_k * density, 0, 1)
        alpha = clip01(colors[:, 3:4] * np.float32(config.density_scale))
        colors = torch.cat([colors[:, :3], alpha], dim=1)
    with torch.no_grad():
        tf_fixed = TransferFunction(tf.lower, tf.upper, colors.detach(),
                                    tf.hg_g)
        args = march.prepare(volume, tf_fixed, camera,
                             config.replace(density_scale=1.0), 0.0)
    return args, colors


def march_bwd_plain(a: MarchArgs, g_rgb: torch.Tensor,
                    g_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel -> dL/dcolors [K, 4]:
    the kernel's two passes with its float order, as a loop over samples
    vectorised over rays.  Each ray sums its terms per interval in sample
    order; the rays' sums are added last."""
    if a.density_scale != 1.0:
        raise ValueError("fold density_scale into the colours first "
                         "(prepare_diff)")
    dev = a.ids.device
    o, d = march._rays(a)
    ids_at = march._sample_ids(a, o, d)
    colors = a.colors
    k = colors.shape[0]
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]

    def sample(i):
        mid = ids_at(i)[0]
        rgba = colors[mid]
        gd = (gr * rgba[..., 0] + gg * rgba[..., 1]) + gb * rgba[..., 2]
        return mid, rgba[..., 3], gd

    shape = (a.width, a.height)
    t = torch.ones(shape, dtype=_f32, device=dev)
    total = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass A
        _, alpha, gd = sample(i)
        w = t * alpha
        total = total + w * gd
        t = t * (1.0 - alpha)
    bg_term = t * g_t

    acc = torch.zeros((a.width * a.height, k, 4), dtype=_f32, device=dev)
    zero = torch.zeros((), dtype=_f32, device=dev)
    t = torch.ones(shape, dtype=_f32, device=dev)
    pfx = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass B
        mid, alpha, gd = sample(i)
        w = t * alpha
        pfx = pfx + w * gd
        suffix = total - pfx
        denom = 1.0 - alpha
        num = suffix + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        t = t * denom
        terms = torch.stack([w * gr, w * gg, w * gb, da], dim=-1)
        acc.scatter_add_(1, mid.reshape(-1, 1, 1).expand(-1, 1, 4),
                         terms.reshape(-1, 1, 4))
    return acc.sum(dim=0)


def num_blocks(width: int, height: int) -> int:
    """Rows of the kernel's partials: one per 16x16 pixel block."""
    return -(-width // BLOCK) * -(-height // BLOCK)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("march_bwd")
    fn = lib.vrp_march_bwd_a1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, d1, d2, d3, depth, width, height, spr,
        # conic, g_rgb, g_t, partials, stream
        fn.argtypes = [p, p, i, p] + [i] * 8 + [p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def march_bwd_kernel(a: MarchArgs, g_rgb: torch.Tensor,
                     g_t: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/march_bwd.cu`` on the current stream and sum its
    per-block partials -> dL/dcolors [K, 4]."""
    global launches
    dev = a.ids.device
    if dev.type != "cuda":
        raise ValueError(f"march_bwd_kernel needs CUDA tensors, got {dev}")
    if a.density_scale != 1.0:
        raise ValueError("fold density_scale into the colours first "
                         "(prepare_diff)")
    for name, t, dtype, shape in (
            ("scal", a.scal, _f32, (SCAL_LEN,)),
            ("colors", a.colors, _f32, None),
            ("ids", a.ids, torch.uint8, a.dims),
            ("g_rgb", g_rgb, _f32, (a.width, a.height, 3)),
            ("g_t", g_t, _f32, (a.width, a.height))):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(t.shape)}")
    k = a.colors.shape[0]
    if not 0 < k <= MAX_INTERVALS or a.colors.shape[1] != 4:
        raise ValueError(f"colors must be [K <= {MAX_INTERVALS}, 4]")
    lib = _kernel_lib()
    partials = torch.empty((num_blocks(a.width, a.height), k, 4), dtype=_f32,
                           device=dev)
    with torch.cuda.device(dev):
        err = lib.vrp_march_bwd_a1(
            a.scal.data_ptr(), a.colors.data_ptr(), k, a.ids.data_ptr(),
            *a.dims, a.depth, a.width, a.height, a.spr, int(a.conic),
            g_rgb.data_ptr(), g_t.data_ptr(), partials.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"backward march kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return partials.sum(dim=0)


def _forward(a: MarchArgs) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    return march.march_kernel(a) if a.ids.is_cuda else march.march_plain(a)


def _backward(a: MarchArgs, g_rgb: torch.Tensor,
              g_t: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if a.ids.is_cuda:
        return march_bwd_kernel(a, g_rgb, g_t)
    return march_bwd_plain(a, g_rgb, g_t)


class _MarchFn(torch.autograd.Function):
    """colors [K, 4] -> image [W, H, 4] through the forward march at eps 0;
    the backward march gives dL/dcolors."""

    @staticmethod
    def forward(ctx, colors: torch.Tensor, a: MarchArgs) -> torch.Tensor:
        a = a._replace(colors=colors.detach().to(_f32).contiguous())
        ctx.args = a
        return _forward(a)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a = ctx.args
        bg = a.scal[S_BG:S_BG + 3]
        g_rgb = g[..., :3].contiguous()
        # the cotangent of T_N through rgb = C + T_N * bg (alpha is 1)
        g_t = ((g_rgb[..., 0] * bg[0] + g_rgb[..., 1] * bg[1])
               + g_rgb[..., 2] * bg[2])
        return _backward(a, g_rgb, g_t), None


def render_vrc_diff(volume, tf: TransferFunction, camera,
                    config: RenderConfig, *, device=None) -> torch.Tensor:
    """a1/VRC render -> [W, H, 4] (alpha 1), differentiable with respect to
    ``tf.colors`` through the forward march (K1) and the backward march
    (K4) on ``device`` (CUDA unless given); CPU tensors take their plain
    versions.  Equal in value to ``render(..., mode="scan")``; the gradient
    equals autograd through that scan except where a sample's alpha is
    exactly 1 (see the module docstring)."""
    dev = resolve_device(device)
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    args, colors = prepare_diff(volume, tf, camera, config)
    return _MarchFn.apply(colors, args)
