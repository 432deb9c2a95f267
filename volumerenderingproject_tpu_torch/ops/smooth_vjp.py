"""The differentiable smooth-mode march: the backward march's plain PyTorch
version, the trilinear adjoint that takes dL/dvn to the volume, the wrapper
of the CUDA kernel that does both (``csrc/smooth_bwd.cu``, K9), the
autograd function that pairs it with the forward march (``ops/smooth.py``,
K8), and the differentiable render.

Counterpart of the backward half of
``volumerenderingproject_tpu/ops/pallas_smooth.py``: ``_smooth_bwd_kernel``
(pallas_smooth.py:349-476), the epilogue ``_splat_volume_grad``
(pallas_smooth.py:478-576) and the custom VJP of
``render_vrc_smooth_pallas`` (pallas_smooth.py:826-894).  The image is
differentiable with respect to the TF colours, the interval bounds and the
volume data.

Per sample, with the per-ray cotangents g (of rgb) and g_t (of T_N), the
two passes of ``ops/march_vjp`` give dL/da_s and w_s = T_s a_s; then, for
k = 1..K-1 (the signs of pallas_smooth.py:424-450):

    dL/dw_k  = w_s (g . (c_k - c_0)) + dL/da_s (a_k - a_0)
    q        = (dL/dw_k * sharp) * w_k
    dL/dvn  += q (s2 - s1)
    dL/dlo_k -= q (1 - s1),   dL/dhi_k += q (1 - s2)
    dL/dc_k  += w_k (w_s g | dL/da_s)
    dL/dc_0  += (1 - sum_k w_k) (w_s g | dL/da_s)

and dL/dvn goes to the eight corners of the sample's trilinear stencil as
dL/dvn / cal_max * wx wy wz (those in range).  The colour terms are kept per
ray as sums of w_k w_s and w_k dL/da_s and multiplied by g at the end of the
ray.  The volume gradient is computed only when ``volume.data`` requires
grad (``ctx.needs_input_grad``), PyTorch's counterpart of JAX's
``volume_grad=False``.  The forward runs at eps 0, as fit.py:209 does: the
backward marches every sample, and an early stop would make the two
disagree.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from ..scene.transfer_function import TransferFunction
from ..utils.config import RenderConfig
from ..utils.device import resolve_device
from . import _build, smooth
from .smooth import S_BG, S_CAL_MAX, S_SHARP, SmoothArgs

_f32 = torch.float32
# the kernel's blocks: 64 pixels along x by 4 along y (csrc/smooth_common.cuh);
# one partial per block
BLOCK_X, BLOCK_Y = 64, 4
NCOLS = 6  # partial columns: dr, dg, db, da, dlower, dupper

# launches of the CUDA kernel since import (or since a caller reset it)
launches = 0

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
              Optional[torch.Tensor]]


def prepare_smooth_diff(volume, tf: TransferFunction, camera,
                        config: RenderConfig) -> SmoothArgs:
    """Smooth march args at eps 0, built from detached copies of the TF and
    the volume (the autograd function takes the live tensors).  Raises
    what ``smooth.prepare_smooth`` raises for a render the kernels do not
    compute."""
    with torch.no_grad():
        fixed = TransferFunction(tf.lower.detach(), tf.upper.detach(),
                                 tf.colors.detach(), tf.hg_g)
        return smooth.prepare_smooth(
            dataclasses.replace(volume, data=volume.data.detach()), fixed,
            camera, config, 0.0)


def splat_volume_grad_plain(dvol: torch.Tensor, dims, vox: torch.Tensor,
                            dvn: torch.Tensor, cal_max: torch.Tensor) -> None:
    """The trilinear adjoint of one sample on every ray, added into ``dvol``
    (flat [X*Y*Z] f32) with ``index_add_``: dvn / cal_max * wx wy wz at the
    eight corners of positions ``vox`` [..., 3] that lie in the volume
    (cf. ``_splat_volume_grad``)."""
    d1, d2, d3 = dims
    base = torch.floor(vox)
    frac = vox - base
    bi = base.to(torch.int32).to(torch.int64)
    gv = dvn / cal_max
    lim = (d1, d2, d3)
    for ox in (0, 1):
        wx = frac[..., 0] if ox else 1.0 - frac[..., 0]
        cx = bi[..., 0] + ox
        for oy in (0, 1):
            wy = frac[..., 1] if oy else 1.0 - frac[..., 1]
            cy = bi[..., 1] + oy
            for oz in (0, 1):
                wz = frac[..., 2] if oz else 1.0 - frac[..., 2]
                cz = bi[..., 2] + oz
                ok = ((cx >= 0) & (cx < lim[0]) & (cy >= 0) & (cy < lim[1])
                      & (cz >= 0) & (cz < lim[2]))
                val = ((gv * wx) * wy) * wz
                ok = ok & (val != 0.0)
                flat = (cx * d2 + cy) * d3 + cz
                dvol.index_add_(0, flat[ok], val[ok])


def march_smooth_bwd_plain(a: SmoothArgs, g_rgb: torch.Tensor,
                           g_t: torch.Tensor,
                           volume_grad: bool = False) -> Grads:
    """Plain PyTorch version of the backward kernel -> (dL/dcolors [K, 4],
    dL/dlower [K], dL/dupper [K], dL/dvolume [X, Y, Z] or None): the
    kernel's two passes in its float order, a loop over samples vectorised
    over rays.  Each ray sums its terms in sample order; the rays' sums are
    added last.  With ``volume_grad`` every sample's dL/dvn is splatted
    (:func:`splat_volume_grad_plain`) as pass B reaches it, so memory stays
    O(W*H) plus the volume."""
    dev = a.scal.device
    k = a.colors.shape[0]
    sample = smooth.sample_fn(a)
    sharp = a.scal[S_SHARP]
    cal = a.scal[S_CAL_MAX]
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]
    dk = a.colors[1:] - a.colors[0]
    gdk = ((gr[..., None] * dk[:, 0] + gg[..., None] * dk[:, 1])
           + gb[..., None] * dk[:, 2])

    def gdot(rgba):
        return (gr * rgba[..., 0] + gg * rgba[..., 1]) + gb * rgba[..., 2]

    shape = (a.width, a.height)
    t = torch.ones(shape, dtype=_f32, device=dev)
    total = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass A
        rgba = sample(i)[0]
        alpha = rgba[..., 3]
        total = total + (t * alpha) * gdot(rgba)
        t = t * (1.0 - alpha)
    bg_term = t * g_t

    sw, sda, dlo, dhi = (torch.zeros(shape + (k,), dtype=_f32, device=dev)
                         for _ in range(4))
    dvol = (torch.zeros(a.data.numel(), dtype=_f32, device=dev)
            if volume_grad else None)
    zero = torch.zeros((), dtype=_f32, device=dev)
    t = torch.ones(shape, dtype=_f32, device=dev)
    pfx = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass B
        rgba, s1, s2, w, vox = sample(i)
        alpha = rgba[..., 3]
        gd = gdot(rgba)
        ws = t * alpha
        pfx = pfx + ws * gd
        suffix = total - pfx
        denom = 1.0 - alpha
        num = suffix + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        t = t * denom
        dldw = ws[..., None] * gdk + da[..., None] * dk[:, 3]
        q = (dldw * sharp) * w
        dvn = torch.zeros(shape, dtype=_f32, device=dev)
        wsum = torch.zeros(shape, dtype=_f32, device=dev)
        for j in range(k - 1):
            dvn = dvn + q[..., j] * (s2[..., j] - s1[..., j])
            wsum = wsum + w[..., j]
        dlo[..., 1:] = dlo[..., 1:] - q * (1.0 - s1)
        dhi[..., 1:] = dhi[..., 1:] + q * (1.0 - s2)
        sw[..., 1:] = sw[..., 1:] + w * ws[..., None]
        sda[..., 1:] = sda[..., 1:] + w * da[..., None]
        base = 1.0 - wsum
        sw[..., 0] = sw[..., 0] + base * ws
        sda[..., 0] = sda[..., 0] + base * da
        if dvol is not None:
            splat_volume_grad_plain(dvol, a.dims, vox, dvn, cal)
    dcolors = torch.stack([gr[..., None] * sw, gg[..., None] * sw,
                           gb[..., None] * sw, sda], dim=-1).sum(dim=(0, 1))
    return (dcolors, dlo.sum(dim=(0, 1)), dhi.sum(dim=(0, 1)),
            None if dvol is None else dvol.reshape(a.dims))


def num_blocks(width: int, height: int) -> int:
    """Rows of the kernel's partials: one per block of 64 x 4 pixels."""
    return -(-width // BLOCK_X) * -(-height // BLOCK_Y)


def _kernel_lib() -> ctypes.CDLL:
    return bind(_build.load("smooth_bwd"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/smooth_bwd.cu (this tree's or another
    checkout's), with the C signature of ``vrp_smooth_bwd`` set."""
    fn = lib.vrp_smooth_bwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, lower, upper, colors, K, vol, d1, d2, d3, width, height, spr,
        # conic, g_rgb, g_t, partials, dvol, stream
        fn.argtypes = [p, p, p, p, i, p] + [i] * 7 + [p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def march_smooth_bwd_kernel(a: SmoothArgs, g_rgb: torch.Tensor,
                            g_t: torch.Tensor,
                            volume_grad: bool = False) -> Grads:
    """Launch ``csrc/smooth_bwd.cu`` on the current stream -> what
    :func:`march_smooth_bwd_plain` returns.  The per-block partials are
    summed with ``torch.sum``; the volume gradient is added by atomics in
    the kernel, so its bits vary from run to run by ulps."""
    global launches
    dev = smooth.check_kernel_args(a)
    for name, t, shape in (("g_rgb", g_rgb, (a.width, a.height, 3)),
                           ("g_t", g_t, (a.width, a.height))):
        if t.device != dev or t.dtype != _f32 or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(t.shape)}")
    k = a.colors.shape[0]
    lib = _kernel_lib()
    partials = torch.empty((num_blocks(a.width, a.height), k, NCOLS),
                           dtype=_f32, device=dev)
    dvol = (torch.zeros(a.dims, dtype=_f32, device=dev) if volume_grad
            else None)
    with torch.cuda.device(dev):
        err = lib.vrp_smooth_bwd(
            a.scal.data_ptr(), a.lower.data_ptr(), a.upper.data_ptr(),
            a.colors.data_ptr(), k, a.data.data_ptr(), *a.dims, a.width,
            a.height, a.spr, int(a.conic), g_rgb.data_ptr(), g_t.data_ptr(),
            partials.data_ptr(), None if dvol is None else dvol.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"smooth backward kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    summed = partials.sum(dim=0)
    return summed[:, :4], summed[:, 4], summed[:, 5], dvol


def _forward(a: SmoothArgs) -> torch.Tensor:
    """K8 on CUDA tensors, its plain version on CPU tensors."""
    if a.data.is_cuda:
        return smooth.march_smooth_kernel(a)
    return smooth.march_smooth_plain(a)


def _backward(a: SmoothArgs, g_rgb: torch.Tensor, g_t: torch.Tensor,
              volume_grad: bool) -> Grads:
    """K9 on CUDA tensors, its plain version on CPU tensors."""
    if a.data.is_cuda:
        return march_smooth_bwd_kernel(a, g_rgb, g_t, volume_grad)
    return march_smooth_bwd_plain(a, g_rgb, g_t, volume_grad)


class _SmoothMarchFn(torch.autograd.Function):
    """(colors [K, 4], lower [K], upper [K], data [X, Y, Z]) -> image
    [W, H, 4] through the smooth march at eps 0; the backward march gives
    the four gradients, the volume's only where it is asked for."""

    @staticmethod
    def forward(ctx, colors, lower, upper, data, a: SmoothArgs):
        a = a._replace(
            colors=colors.detach().to(_f32).contiguous(),
            lower=lower.detach().to(_f32).contiguous(),
            upper=upper.detach().to(_f32).contiguous(),
            data=data.detach().to(_f32).contiguous())
        ctx.args = a
        ctx.data_shape = data.shape
        return _forward(a)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a = ctx.args
        bg = a.scal[S_BG:S_BG + 3]
        g_rgb = g[..., :3].contiguous()
        # the cotangent of T_N through rgb = C + T_N * bg (alpha is 1)
        g_t = ((g_rgb[..., 0] * bg[0] + g_rgb[..., 1] * bg[1])
               + g_rgb[..., 2] * bg[2])
        volume_grad = ctx.needs_input_grad[3]
        dcol, dlo, dhi, dvol = _backward(a, g_rgb, g_t, volume_grad)
        if dvol is not None:
            dvol = dvol.reshape(ctx.data_shape)
        return dcol, dlo, dhi, dvol, None


def render_vrc_smooth_diff(volume, tf: TransferFunction, camera,
                           config: RenderConfig, *, device=None
                           ) -> torch.Tensor:
    """Smooth-mode a1 render -> [W, H, 4] (alpha 1), differentiable with
    respect to ``tf.colors``, ``tf.lower``, ``tf.upper`` and, where it
    requires grad, ``volume.data``, through K8 forward (at eps 0) and K9
    backward on ``device`` (CUDA unless given); CPU tensors take their plain
    versions.  Equal in value to ``render(..., mode="fast")`` at
    ``early_termination=0``."""
    dev = resolve_device(device)
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    a = prepare_smooth_diff(volume, tf, camera, config)
    return _SmoothMarchFn.apply(tf.colors, tf.lower, tf.upper, volume.data, a)
