"""The differentiable a1 march: the backward march's plain PyTorch version,
the wrapper of its CUDA kernel (``csrc/march_bwd.cu``), the autograd
functions that pair it with the forward march (``ops/march.py``), and the
differentiable renders.

Counterpart of ``volumerenderingproject_tpu/ops/pallas_march_vjp.py`` on the
a1 path: ``_march_bwd_kernel`` in its plain, ``baked_light``, ``lut_n`` and
LUT + baked-light variants (no slab or multichannel), the ``_make_core``
custom VJP, the light-differentiable ``_make_lit_core`` and
``render_vrc_pallas_diff``.

Backward math (front-to-back over in (C, T) form, output alpha 1):

    forward:  w_s = T_s a_s,  C += w_s c'_s,  T_{s+1} = T_s (1 - a_s)
    output:   rgb = C + T_N * bg

where c'_s is the sample's colour c_s, or with baked light the shaded
c_s M_v + S_v at its voxel v (M = 1, S = 0 off the volume).  With the
per-ray cotangents g (of rgb) and g_t (of T_N, through + T_N*bg):

    dL/dc_s = g * w_s * M_v
    dL/da_s = T_s (g . c'_s) - (S_{>s} + T_N g_t) / (1 - a_s)
    S_{>s}  = sum_{j>s} w_j (g . c'_j)

in two passes per ray: pass A sums total = sum_j w_j (g . c'_j) and T_N;
pass B marches again keeping the prefix P_s in pass A's float order, so
S_{>s} = total - P_s.  Where 1 - a_s == 0 the division term is gated to 0,
as in the TPU kernel (the true limit would need a third pass).  The
backward marches every sample: a sample of alpha 0 still has an alpha
gradient, so the forward's skips do not apply.  Each sample's terms go to
the interval of its id; samples off the volume go to ``id0``.  With a LUT
(``config.tf_lut``) entry i of the LUT is the colour of interval
``itv[i]`` (``TransferFunction.to_lut`` gathers them), so a sample's terms
go to the interval of the entry it read, and the gradient is dL/dcolors
[K, 4] of the TF, never of a LUT row.

Light parameters (``render_vrc_diff(..., light=...)``): lighting touches
rgb only, so the render is linear in the baked grids, and the gradient of
light parameter p is <g, C(dM_p, dS_p)> - <g, C(0, 0)>, two forward
marches of the baked variant on the bake's tangent grids
(``ops/phong.bake_tangents``); the second removes the samples off the
volume, which the march shades with the constants (1, 0).  That is 11
forward marches per backward.

The forward runs at ``early_eps = 0`` with ``density_scale`` folded into the
alpha column (its clip included), so the march runs with density 1 and the
chain rule through the fold reaches the raw colours.  The colours (and the
light vector) get a gradient: ids, bricks, the baked grids of a fixed light
and the scalars are built under ``no_grad``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..scene.transfer_function import TransferFunction
from ..utils.config import Algorithm, Interp, RenderConfig
from ..utils.device import resolve_device
from . import _build, conv3d, march, phong
from .march import MAX_LUT, S_BG, SCAL_LEN, MarchArgs

_f32 = torch.float32
MAX_INTERVALS = 16  # the JAX kernel's limit (pallas_march_vjp.py:1538)
BLOCK = 16  # pixels per edge of the kernel's blocks; one partial per block

# launches of the CUDA kernel since import (or since a caller reset them),
# in all and by variant (``march.variant``: plain, lut, baked, lut_baked)
launches = 0
variant_launches = {"plain": 0, "lut": 0, "baked": 0, "lut_baked": 0}


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient: at a bound each side of the
    tie takes half (``torch.clamp`` would pass all of it)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def check_diff_supported(config: RenderConfig, channels: int,
                         num_intervals: int) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item, for what the
    differentiable march does not compute (cf. ``diff_pallas_eligible``):
    it takes one-channel, nearest-voxel renders of at most 16 intervals,
    lit through the bake (ortho) or not, through the interval scan or a
    LUT."""
    march.check_supported(config, channels)
    if config.interp is Interp.TRILINEAR:
        raise NotImplementedError(
            "the differentiable nearest-voxel march (K4) does not sample "
            "Interp.TRILINEAR: smooth renders differentiate through "
            "ops/smooth_vjp.render_vrc_smooth_diff (ROADMAP.md item 12, "
            "smooth mode)")
    if config.lighting and config.conic:
        raise NotImplementedError(
            "conic lit fits are not ported yet: ROADMAP.md item 11a (the "
            "scan route for fits; the JAX package fits them through its XLA "
            "scan) and item 9.3 (K1's in-kernel lighting variant)")
    if num_intervals > MAX_INTERVALS:
        raise NotImplementedError(
            f"the differentiable march takes at most {MAX_INTERVALS} TF "
            f"intervals, got {num_intervals}: ROADMAP.md item 11d (the scan "
            "route for fits)")


def check_light_fit_supported(config: RenderConfig, channels: int,
                              num_intervals: int, light) -> None:
    """What a fit of the light parameters adds to
    :func:`check_diff_supported` (cf. ``diff_pallas_light_eligible``): an
    a1 render with ortho rays, no LUT and a uniform light colour; the rest
    raises NotImplementedError naming its ROADMAP.md item."""
    if config.algorithm is not Algorithm.VRC or (
            config.interp is Interp.TRILINEAR):
        raise NotImplementedError(
            "light fits of a5 or smooth renders are not ported yet: "
            "ROADMAP.md item 11a (the scan route for fits; the JAX package "
            "fits them through its XLA scan)")
    check_diff_supported(config, channels, num_intervals)
    if config.conic:
        raise NotImplementedError(
            "conic light fits are not ported yet: ROADMAP.md item 11a (the "
            "scan route for fits; the JAX package fits them through its XLA "
            "scan)")
    if config.tf_lut:
        raise NotImplementedError(
            "a light fit through a LUT is not computed by the fused marches "
            "(the JAX package raises too, pallas_march_vjp.py:1661-1664): "
            "ROADMAP.md item 11a (the scan route for fits)")
    c = light.color.reshape(-1)
    if not bool((c == c[0]).all()):
        raise NotImplementedError(
            "a light fit from a non-uniform light colour is not ported yet: "
            "ROADMAP.md item 11a (the scan route for fits; the baked march "
            "shades with one colour)")


def diff_eligible(volume, tf: TransferFunction, config: RenderConfig) -> bool:
    """True when :func:`render_vrc_diff` computes this render
    (cf. ``diff_pallas_eligible``): a1 classify by intervals or a LUT, lit
    (ortho) or not, one channel, nearest-voxel sampling, at most 16
    intervals."""
    try:
        check_diff_supported(config, volume.channels, tf.num_intervals)
    except NotImplementedError:
        return False
    return True


def diff_light_eligible(volume, tf: TransferFunction, config: RenderConfig,
                        light=None) -> bool:
    """True when :func:`render_vrc_diff` fits the light parameters of this
    render (cf. ``diff_pallas_light_eligible``): :func:`diff_eligible`, a1,
    ortho rays, no LUT (and a uniform colour of ``light`` where given)."""
    light = phong.default_light(tf.colors.device) if light is None else light
    try:
        check_light_fit_supported(config, volume.channels, tf.num_intervals,
                                  light)
    except NotImplementedError:
        return False
    return True


def prepare_diff(volume, tf: TransferFunction, camera, config: RenderConfig,
                 bake: bool = True) -> Tuple[MarchArgs, torch.Tensor]:
    """(march args at eps 0 and density 1, the colours with the static
    ``density_scale`` folded into alpha).  The colours keep their autograd
    history; the args are built from a detached copy: with lighting the
    baked (M, S) of the default light (``bake=False`` leaves them to the
    caller, as a light fit bakes its own), with ``tf_lut`` the uint16
    LUT-index grid and ``itv``, the interval of every LUT entry, beside the
    TF's own colours."""
    check_diff_supported(config, volume.channels, tf.num_intervals)
    colors = tf.colors.to(volume.data.device)
    if config.density_scale != 1.0:
        # pallas_march_vjp.py:1682-1687: a_k -> clip(a_k * density, 0, 1)
        alpha = clip01(colors[:, 3:4] * np.float32(config.density_scale))
        colors = torch.cat([colors[:, :3], alpha], dim=1)
    with torch.no_grad():
        tf_fixed = TransferFunction(tf.lower, tf.upper, colors.detach(),
                                    tf.hg_g)
        args = march.prepare(
            volume, tf_fixed, camera,
            config.replace(density_scale=1.0, lighting=config.lighting
                           and bake), 0.0)
        if config.tf_lut:
            itv = tf_fixed.lut_intervals(config.tf_lut).to(torch.uint8)
            args = args._replace(colors=colors.detach().to(_f32).contiguous(),
                                 itv=itv)
    return args, colors


def _fwd_args(a: MarchArgs) -> MarchArgs:
    """The forward march's args: with a LUT its entries, ``colors[itv]``
    (what ``to_lut`` gives, bit for bit)."""
    if a.itv is None:
        return a
    return a._replace(colors=a.colors[a.itv.long()].contiguous(), itv=None)


def march_bwd_plain(a: MarchArgs, g_rgb: torch.Tensor,
                    g_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel -> dL/dcolors [K, 4]:
    the kernel's two passes with its float order, as a loop over samples
    vectorised over rays, in every variant (interval ids or LUT indices,
    baked light or not).  Each ray sums its terms per interval in sample
    order; the rays' sums are added last."""
    if a.density_scale != 1.0:
        raise ValueError("fold density_scale into the colours first "
                         "(prepare_diff)")
    lut = a.ids.dtype == torch.uint16
    if lut != (a.itv is not None):
        raise ValueError("LUT indices need itv, interval ids none")
    dev = a.ids.device
    o, d = march._rays(a)
    ids_at = march._sample_ids(a, o, d)
    colors = a.colors
    k = colors.shape[0]
    itv = a.itv.long() if lut else None
    baked = a.mgrid is not None
    if baked:
        mflat, sflat = a.mgrid.reshape(-1), a.sgrid.reshape(-1)
        one = torch.ones((), dtype=_f32, device=dev)
        zero_f = torch.zeros((), dtype=_f32, device=dev)
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]

    def sample(i):
        """(interval, alpha, g . c', M) of every ray's sample i."""
        sid, valid, flat = ids_at(i)
        mid = itv[sid] if lut else sid
        rgba = colors[mid]
        r, g, b = rgba[..., 0], rgba[..., 1], rgba[..., 2]
        m = None
        if baked:  # c' = c * M + S; off the volume M = 1, S = 0
            m = torch.where(valid, mflat[flat], one)
            sh = torch.where(valid, sflat[flat], zero_f)
            r, g, b = r * m + sh, g * m + sh, b * m + sh
        gd = (gr * r + gg * g) + gb * b
        return mid, rgba[..., 3], gd, m

    shape = (a.width, a.height)
    t = torch.ones(shape, dtype=_f32, device=dev)
    total = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass A
        _, alpha, gd, _ = sample(i)
        w = t * alpha
        total = total + w * gd
        t = t * (1.0 - alpha)
    bg_term = t * g_t

    acc = torch.zeros((a.width * a.height, k, 4), dtype=_f32, device=dev)
    zero = torch.zeros((), dtype=_f32, device=dev)
    t = torch.ones(shape, dtype=_f32, device=dev)
    pfx = torch.zeros(shape, dtype=_f32, device=dev)
    for i in range(a.spr):  # pass B
        mid, alpha, gd, m = sample(i)
        w = t * alpha
        pfx = pfx + w * gd
        suffix = total - pfx
        denom = 1.0 - alpha
        num = suffix + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        t = t * denom
        wm = w * m if baked else w  # dC/dc = w M
        terms = torch.stack([wm * gr, wm * gg, wm * gb, da], dim=-1)
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
        # scal, colors, K, ids, id_bytes, itv, lut_n, mgrid, sgrid, d1, d2,
        # d3, depth, width, height, spr, conic, g_rgb, g_t, partials, stream
        fn.argtypes = ([p, p, i, p, i, p, i, p, p] + [i] * 8
                       + [p, p, p, p])
        fn.restype = ctypes.c_int
    return lib


def march_bwd_kernel(a: MarchArgs, g_rgb: torch.Tensor,
                     g_t: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/march_bwd.cu`` on the current stream and sum its
    per-block partials -> dL/dcolors [K, 4].  The variant follows the args
    (``march.variant``): uint8 interval ids or uint16 LUT indices with
    ``itv``, with baked (M, S) grids or without."""
    global launches
    dev = a.ids.device
    if dev.type != "cuda":
        raise ValueError(f"march_bwd_kernel needs CUDA tensors, got {dev}")
    if a.density_scale != 1.0:
        raise ValueError("fold density_scale into the colours first "
                         "(prepare_diff)")
    lut = a.ids.dtype == torch.uint16
    baked = a.mgrid is not None
    if lut != (a.itv is not None) or baked != (a.sgrid is not None):
        raise ValueError("LUT indices need itv; mgrid and sgrid go together")
    checks = [("scal", a.scal, _f32, (SCAL_LEN,)),
              ("colors", a.colors, _f32, None),
              ("ids", a.ids, torch.uint16 if lut else torch.uint8, a.dims),
              ("g_rgb", g_rgb, _f32, (a.width, a.height, 3)),
              ("g_t", g_t, _f32, (a.width, a.height))]
    if lut:
        checks.append(("itv", a.itv, torch.uint8, None))
    if baked:
        checks += [("mgrid", a.mgrid, _f32, a.dims),
                   ("sgrid", a.sgrid, _f32, a.dims)]
    for name, t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {shape}, got "
                             f"{tuple(t.shape)}")
    k = a.colors.shape[0]
    if not 0 < k <= MAX_INTERVALS or a.colors.shape[1] != 4:
        raise ValueError(f"colors must be [K <= {MAX_INTERVALS}, 4]")
    lut_n = a.itv.numel() if lut else 0
    if lut and not 0 < lut_n <= MAX_LUT:
        raise ValueError(f"itv must have 1..{MAX_LUT} entries, got {lut_n}")
    lib = _kernel_lib()
    partials = torch.empty((num_blocks(a.width, a.height), k, 4), dtype=_f32,
                           device=dev)
    with torch.cuda.device(dev):
        err = lib.vrp_march_bwd_a1(
            a.scal.data_ptr(), a.colors.data_ptr(), k, a.ids.data_ptr(),
            a.ids.element_size(), a.itv.data_ptr() if lut else None, lut_n,
            a.mgrid.data_ptr() if baked else None,
            a.sgrid.data_ptr() if baked else None,
            *a.dims, a.depth, a.width, a.height, a.spr, int(a.conic),
            g_rgb.data_ptr(), g_t.data_ptr(), partials.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"backward march kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    variant_launches[march.variant(a)] += 1
    return partials.sum(dim=0)


def _forward(a: MarchArgs) -> torch.Tensor:
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    a = _fwd_args(a)
    return march.march_kernel(a) if a.ids.is_cuda else march.march_plain(a)


def _backward(a: MarchArgs, g_rgb: torch.Tensor,
              g_t: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if a.ids.is_cuda:
        return march_bwd_kernel(a, g_rgb, g_t)
    return march_bwd_plain(a, g_rgb, g_t)


def _cotangents(a: MarchArgs, g: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g_rgb [W, H, 3], g_t [W, H]): the image cotangent's rgb part and
    the cotangent of T_N through rgb = C + T_N * bg (alpha is 1)."""
    bg = a.scal[S_BG:S_BG + 3]
    g_rgb = g[..., :3].contiguous()
    g_t = ((g_rgb[..., 0] * bg[0] + g_rgb[..., 1] * bg[1])
           + g_rgb[..., 2] * bg[2])
    return g_rgb, g_t


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
        return _backward(a, *_cotangents(a, g)), None


def light_grad(a: MarchArgs, g_rgb: torch.Tensor, grad: torch.Tensor,
               light_vec: torch.Tensor, view_dir: torch.Tensor
               ) -> torch.Tensor:
    """dL/dlight_vec [10] of a baked march ``a`` (cf. ``_make_lit_core``):
    <g, C(dM_p, dS_p)> - <g, C(0, 0)> per parameter p, with (dM_p, dS_p)
    the bake's tangents on the gradient field ``grad`` and C the march's
    colour sum (the background off), 11 forward marches in all."""
    dm, ds = phong.bake_tangents(None, None, light_vec, view_dir, grad=grad)
    scal = a.scal.clone()
    scal[S_BG:S_BG + 3] = 0.0  # out = C
    t = a._replace(scal=scal)

    def dot(mg, sg):
        return (g_rgb * _forward(t._replace(mgrid=mg, sgrid=sg))[..., :3]).sum()

    zero = torch.zeros_like(a.mgrid)
    oov = dot(zero, zero)  # the off-volume samples' constant (1, 0)
    return torch.stack([dot(dm[p], ds[p]) - oov
                        for p in range(phong.N_LIGHT_PARAMS)])


class _LitMarchFn(torch.autograd.Function):
    """(colors [K, 4], light_vec [10]) -> image [W, H, 4]: the bake of the
    light vector on the gradient field ``grad``, then the baked forward
    march at eps 0; the backward march gives dL/dcolors and
    :func:`light_grad` dL/dlight_vec."""

    @staticmethod
    def forward(ctx, colors: torch.Tensor, light_vec: torch.Tensor,
                a: MarchArgs, grad: torch.Tensor, view_dir: torch.Tensor
                ) -> torch.Tensor:
        light_vec = light_vec.detach().to(_f32)
        mgrid, sgrid = phong.bake_light_vec(grad, light_vec, view_dir)
        a = a._replace(colors=colors.detach().to(_f32).contiguous(),
                       mgrid=mgrid, sgrid=sgrid)
        ctx.args, ctx.grad, ctx.view_dir = a, grad, view_dir
        ctx.light_vec = light_vec
        return _forward(a)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a = ctx.args
        g_rgb, g_t = _cotangents(a, g)
        dcolors = dlight = None
        if ctx.needs_input_grad[0]:
            dcolors = _backward(a, g_rgb, g_t)
        if ctx.needs_input_grad[1]:
            dlight = light_grad(a, g_rgb, ctx.grad, ctx.light_vec,
                                ctx.view_dir)
        return dcolors, dlight, None, None, None


def render_vrc_diff(volume, tf: TransferFunction, camera,
                    config: RenderConfig, *, device=None,
                    light: phong.Light | None = None) -> torch.Tensor:
    """a1/VRC render -> [W, H, 4] (alpha 1), differentiable with respect to
    ``tf.colors`` through the forward march (K1) and the backward march
    (K4) on ``device`` (CUDA unless given); CPU tensors take their plain
    versions.  Lit configs shade with the default light's baked grids, LUT
    configs classify through ``tf.to_lut``.  With ``light``, the render is
    shaded with it and differentiable with respect to its fields too
    (:func:`check_light_fit_supported`).  Equal in value to
    ``render(..., mode="scan")``; the gradient equals autograd through that
    scan except where a sample's alpha is exactly 1 (see the module
    docstring)."""
    dev = resolve_device(device)
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    if light is None:
        args, colors = prepare_diff(volume, tf, camera, config)
        return _MarchFn.apply(colors, args)
    light = light.to(dev)
    check_light_fit_supported(config, volume.channels, tf.num_intervals,
                              light)
    args, colors = prepare_diff(volume, tf, camera, config, bake=False)
    with torch.no_grad():
        grad = conv3d.gradient_field(volume.data, config.gradient_filter,
                                     config.presmooth_sigma)
    return _LitMarchFn.apply(colors, phong.light_to_vec(light), args, grad,
                             -camera.front)
