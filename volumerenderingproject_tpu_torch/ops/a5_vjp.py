"""The differentiable a5 march: the backward march's plain PyTorch version,
the wrapper of its CUDA kernel (``csrc/a5_bwd.cu``), the autograd function
that pairs it with the forward a5 march (``ops/a5.py``), and the
differentiable a5 render.

Counterpart of ``volumerenderingproject_tpu/ops/pallas_a5.py``'s diff cores
on the unlit resident path: ``a5_diff_config_ok``, ``_make_a5_core``'s
custom VJP around ``_a5_bwd_kernel``, and ``render_test_pallas_diff``.

The a5 sample colour is linear in the colour table, so sample s has the
per-interval coefficients ``coef_k = sum_corners w_c [id_c == k]`` inside
the volume and ``[id0 == k]`` outside it, and with ``a_s = sum_k coef_k
alpha_k`` and ``rgb_s = sum_k coef_k rgb_k`` (sums in k order) the a1
backward's scheme (``ops/march_vjp.py``) carries over:

    dL/drgb_k   = sum_s coef_k w_s g
    dL/dalpha_k = sum_s coef_k (T_s (g . rgb_s) - (S_{>s} + T_N g_t) / (1 - a_s))

in two passes per ray (pass A: the total and T_N; pass B: the prefix), with
the division term gated to 0 where ``1 - a_s == 0``.  Both passes
recompute a and rgb in this coefficient form, as the TPU kernel does, so
the suffix at the last sample is exactly 0; the forward's mixed form can
differ from it in the last bits.  Every sample is marched.

The forward runs at ``early_eps = 0``.  The a5 path reads no
``density_scale`` (the fit folds its own density into the alpha column), so
no fold happens here.  Only the colours get a gradient: the id grid and the
scalars are built from a detached copy.
"""

from __future__ import annotations

import ctypes

import torch

from ..scene.transfer_function import TransferFunction
from ..utils.config import RenderConfig
from ..utils.device import resolve_device
from . import _build, a5
from .a5 import S_BG, S_ID0, A5Args
from .march_vjp import num_blocks

_f32 = torch.float32
MAX_INTERVALS = 16  # the JAX kernel's limit (a5_diff_config_ok)

# launches of the CUDA kernel since import (or since a caller reset it)
launches = 0


def check_diff_supported(config: RenderConfig, channels: int,
                         num_intervals: int) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for what the
    differentiable a5 march of this slice does not compute (cf.
    ``a5_diff_config_ok``): it takes unlit, one-channel renders of at most
    16 intervals."""
    a5.check_supported(config, channels)
    if config.lighting:
        raise NotImplementedError(
            "lit a5 fits are not ported yet: ROADMAP.md item 9 (lighting, "
            "LUT and scattering) and item 11 (K6's baked-light variant)")
    if num_intervals > MAX_INTERVALS:
        raise NotImplementedError(
            f"the differentiable a5 march takes at most {MAX_INTERVALS} TF "
            f"intervals, got {num_intervals}: ROADMAP.md item 11 (K6 "
            "variants)")


def prepare_a5_diff(volume, tf: TransferFunction, camera,
                    config: RenderConfig):
    """(a5 args at eps 0, the colours on the volume's device).  The colours
    keep their autograd history; the args are built from a detached
    copy."""
    check_diff_supported(config, volume.channels, tf.num_intervals)
    colors = tf.colors.to(volume.data.device)
    with torch.no_grad():
        tf_fixed = TransferFunction(tf.lower, tf.upper, colors.detach(),
                                    tf.hg_g)
        args = a5.prepare_a5(volume, tf_fixed, camera, config, 0.0)
    return args, colors


def _coef_samples(a: A5Args):
    """``sample(i) -> (coef [W, H, K], alpha [W, H], rgb [W, H, 3])``:
    sample i of every ray in coefficient form, in the kernel's float
    order."""
    corners = a5._corners(a)
    dev = a.ids.device
    k = a.colors.shape[0]
    karange = torch.arange(k, device=dev)
    id0 = a.scal[S_ID0].to(torch.int64)
    outside = (karange == id0).to(_f32)
    zero = torch.zeros((), dtype=_f32, device=dev)

    def sample(i: int):
        mid, frac, inside, _ = corners(i)
        fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
        gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
        wts = ((gy * gx) * gz, (gy * gx) * fz, (fy * gx) * gz, (fy * gx) * fz,
               (gy * fx) * gz, (gy * fx) * fz, (fy * fx) * gz, (fy * fx) * fz)
        coef = torch.zeros(mid.shape[:-1] + (k,), dtype=_f32, device=dev)
        for c, wt in enumerate(wts):
            coef = coef + torch.where(mid[..., c:c + 1] == karange,
                                      wt[..., None], zero)
        coef = torch.where(inside[..., None], coef, outside)
        col = torch.zeros(mid.shape[:-1] + (4,), dtype=_f32, device=dev)
        for j in range(k):
            col = col + coef[..., j:j + 1] * a.colors[j]
        return coef, col[..., 3], col[..., :3]

    return sample


def march_a5_bwd_plain(a: A5Args, g_rgb: torch.Tensor,
                       g_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel -> dL/dcolors [K, 4]:
    the kernel's two passes with its float order, as a loop over samples
    vectorised over rays.  Each ray sums its terms per interval in sample
    order; the rays' sums are added last."""
    dev = a.ids.device
    sample = _coef_samples(a)
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]
    shape = (a.width, a.height)
    t = torch.ones(shape, dtype=_f32, device=dev)
    total = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass A
        _, alpha, rgb = sample(i)
        gd = (gr * rgb[..., 0] + gg * rgb[..., 1]) + gb * rgb[..., 2]
        total = total + (t * alpha) * gd
        t = t * (1.0 - alpha)
    bg_term = t * g_t

    acc = torch.zeros(shape + (a.colors.shape[0], 4), dtype=_f32, device=dev)
    zero = torch.zeros((), dtype=_f32, device=dev)
    g4 = torch.stack([gr, gg, gb], dim=-1)[..., None, :]
    t = torch.ones(shape, dtype=_f32, device=dev)
    pfx = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass B
        coef, alpha, rgb = sample(i)
        gd = (gr * rgb[..., 0] + gg * rgb[..., 1]) + gb * rgb[..., 2]
        w = t * alpha
        pfx = pfx + w * gd
        suffix = total - pfx
        denom = 1.0 - alpha
        num = suffix + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        t = t * denom
        cw = (coef * w[..., None])[..., None]
        acc = acc + torch.cat([cw * g4, (coef * da[..., None])[..., None]],
                              dim=-1)
    return acc.sum(dim=(0, 1))


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("a5_bwd")
    fn = lib.vrp_march_bwd_a5
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, d1, d2, d3, width, height, spr, g_rgb, g_t,
        # partials, stream
        fn.argtypes = [p, p, i, p] + [i] * 6 + [p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def march_a5_bwd_kernel(a: A5Args, g_rgb: torch.Tensor,
                        g_t: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/a5_bwd.cu`` on the current stream and sum its
    per-block partials -> dL/dcolors [K, 4]."""
    global launches
    a5.check_kernel_args(a, MAX_INTERVALS, extra=(
        ("g_rgb", g_rgb, _f32, (a.width, a.height, 3)),
        ("g_t", g_t, _f32, (a.width, a.height))))
    dev = a.ids.device
    k = a.colors.shape[0]
    lib = _kernel_lib()
    partials = torch.empty((num_blocks(a.width, a.height), k, 4), dtype=_f32,
                           device=dev)
    with torch.cuda.device(dev):
        err = lib.vrp_march_bwd_a5(
            a.scal.data_ptr(), a.colors.data_ptr(), k, a.ids.data_ptr(),
            *a.dims, a.width, a.height, a.spr, g_rgb.data_ptr(),
            g_t.data_ptr(), partials.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"a5 backward march kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return partials.sum(dim=0)


def _forward(a: A5Args) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    return a5.march_a5_kernel(a) if a.ids.is_cuda else a5.march_a5_plain(a)


def _backward(a: A5Args, g_rgb: torch.Tensor,
              g_t: torch.Tensor) -> torch.Tensor:
    """K6 on CUDA tensors, its plain version on CPU tensors."""
    if a.ids.is_cuda:
        return march_a5_bwd_kernel(a, g_rgb, g_t)
    return march_a5_bwd_plain(a, g_rgb, g_t)


class _A5MarchFn(torch.autograd.Function):
    """colors [K, 4] -> image [W, H, 4] through the a5 march at eps 0; the
    backward march gives dL/dcolors."""

    @staticmethod
    def forward(ctx, colors: torch.Tensor, a: A5Args) -> torch.Tensor:
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


def render_test_diff(volume, tf: TransferFunction, camera,
                     config: RenderConfig, *, device=None) -> torch.Tensor:
    """a5/TEST render -> [W, H, 4] (alpha 1), differentiable with respect to
    ``tf.colors`` through the forward a5 march (K3) and the backward march
    (K6) on ``device`` (CUDA unless given); CPU tensors take their plain
    versions.  Equal in value to ``render(..., mode="scan")`` for a5; the
    gradient equals autograd through that scan up to the float order of
    the coefficient form, except where a sample's alpha is exactly 1."""
    dev = resolve_device(device)
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    args, colors = prepare_a5_diff(volume, tf, camera, config)
    return _A5MarchFn.apply(colors, args)
