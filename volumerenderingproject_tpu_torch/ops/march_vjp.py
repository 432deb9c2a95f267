"""The differentiable a1 march: the backward march's plain PyTorch version,
the wrapper of its CUDA kernel (``csrc/march_bwd.cu``), the autograd
functions that pair it with the forward march (``ops/march.py``), and the
differentiable renders.

Counterpart of ``volumerenderingproject_tpu/ops/pallas_march_vjp.py`` on the
a1 path: ``_march_bwd_kernel`` in its plain, ``baked_light``, ``lut_n``,
LUT + baked-light and ``mc_grids`` variants, with the segment and slab
offsets of a sharded fit's work unit, the ``_make_core`` custom VJP, the
light-differentiable ``_make_lit_core``, the multichannel ``_make_mc_core``,
``render_vrc_pallas_diff`` with ``render_vrc_pallas_diff_multichannel``, and
``render_vrc_pallas_diff_segment``.

Backward math (front-to-back over in (C, T) form, output alpha 1):

    forward:  w_s = T_s a_s,  C += w_s c'_s,  T_{s+1} = T_s (1 - a_s)
    output:   rgb = C + T_N * bg

where c'_s is the sample's colour c_s, or with baked light the shaded
c_s M_v + S_v at its voxel v (M = 1, S = 0 off the volume), or on a 4-D
volume the channel rgb at v (0 off the volume): data, so the rgb columns
of dL/dcolors are exactly 0 there and only the alpha column trains.  With the
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

Single scattering (``config.scattering``, :func:`render_vrc_scatter_diff`)
rides the S grid too, but S depends on the TF's alpha column through the
light's transmittance and on ``tf.hg_g`` through the phase.  At fixed
colours the render is affine in S, so (``_make_scatter_core``,
pallas_march_vjp.py:1199-1331) the gradient of alpha_k through S is
<g, C(M, dS/dalpha_k)> - <g, C(M, 0)>, one march of the baked variant per
interval plus the shared base, each tangent grid a ``torch.func.jvp`` of the
scatter bake; ``hg_g`` takes K more where it requires grad.  The direct
part (classify and recurrence at fixed S) is the baked backward march.

A sharded fit's work unit (``parallel/render_dist.py``; the unit keywords
of ``march.prepare``) returns its raw (C, T) pair, and the cotangents are
those of C and of the unit's own final T, which the fold's autograd gives;
on an x-slab a sample that another slab owns is the over identity in both
passes, alpha 0, and scatters into no interval, so the slabs' gradients sum
to the whole render's.  A lit slab takes the whole volume's bake cropped to
its planes (the normals cross its faces), and a light fit runs on the rays
and samples axes only, where its tangent marches are segment marches and
their inner product takes the cotangent of C alone (the light moves no
alpha, and a unit has no background term).

The forward runs at ``early_eps = 0`` with ``density_scale`` folded into the
alpha column (its clip included), so the march runs with density 1 and the
chain rule through the fold reaches the raw colours; the scatter bake then
runs at density 1 too, as the JAX scatter core's does, or it would apply
the fold twice.  The colours (and the light vector) get a gradient: ids,
bricks, the baked grids of a fixed light and the scalars are built under
``no_grad``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..scene.transfer_function import TransferFunction
from ..utils.config import Algorithm, Interp, RenderConfig
from ..utils.device import resolve_device
from . import _build, conv3d, march, phong
from .march import MAX_LUT, S_BG, SCAL_LEN, MarchArgs
from .phong import clip01

_f32 = torch.float32
MAX_INTERVALS = 16  # the JAX kernel's limit (pallas_march_vjp.py:1538)
# a block's pixels along y and x (csrc/march_bwd.cu kBlockY, kBlockX); one
# partial per block
BLOCK_Y, BLOCK_X = 4, 64

# launches of the CUDA kernel since import (or since a caller reset them),
# in all and by variant (``march.variant``: plain, lut, baked, lut_baked)
launches = 0
variant_launches = {"plain": 0, "lut": 0, "baked": 0, "lut_baked": 0,
                    "mc": 0}
# and the launches that took a sharded fit's work unit: a segment over the
# whole volume, or one on an x-slab of it
shard_launches = {"segment": 0, "slab": 0}


def check_mc_fit_supported(config: RenderConfig, channels: int) -> None:
    """A fit of a 4-D volume (cf. ``diff_pallas_mc_eligible``,
    pallas_march_vjp.py:2228-2245): an a1 nearest-voxel render with ortho
    rays, unlit, unscattered, without a LUT; the rest raises
    NotImplementedError naming ``mode='scan'``, which fits it, or, for
    scattering, the JAX package's reason."""
    if channels == 1:
        return
    if config.scattering:
        phong.check_scatter_channels(channels)
    what = None
    if config.algorithm is not Algorithm.VRC:
        what = "a5 fits of 4-D volumes"
    elif config.conic:
        what = "conic fits of 4-D volumes"
    elif config.lighting or config.tf_lut:
        what = "lit or LUT fits of 4-D volumes"
    elif config.interp is not Interp.NEAREST:
        what = "smooth fits of 4-D volumes"
    if what is not None:
        raise NotImplementedError(
            f"no differentiable kernel computes {what} (the JAX package's "
            "multichannel diff kernels take ortho, unlit, unscattered "
            "nearest-voxel a1 renders, and it fits the rest through its XLA "
            "scan): mode='scan' fits them")


def check_diff_supported(config: RenderConfig, channels: int,
                         num_intervals: int) -> None:
    """Raise NotImplementedError, naming the route that computes it
    (``mode='scan'``, or the smooth marches), for what the differentiable
    march does not compute (cf. ``diff_pallas_eligible`` and
    ``diff_pallas_mc_eligible``): it takes nearest-voxel renders of at
    most 16 intervals, one-channel ones lit through the bake (ortho) or
    not, through the interval scan or a LUT, and 4-D ones as
    :func:`check_mc_fit_supported` says."""
    check_mc_fit_supported(config, channels)
    if config.interp is Interp.TRILINEAR:
        raise NotImplementedError(
            "the differentiable nearest-voxel march (K4) does not sample "
            "Interp.TRILINEAR: smooth renders differentiate through "
            "ops/smooth_vjp.render_vrc_smooth_diff (ROADMAP.md item 12, "
            "smooth mode)")
    if config.interp is Interp.TRILINEAR_COLOR:
        raise NotImplementedError(
            "the differentiable march samples the nearest voxel, as the JAX "
            "package's kernels do (raycast.py:683): mode='scan' fits "
            "Interp.TRILINEAR_COLOR")
    if config.lighting and config.conic:
        raise NotImplementedError(
            "no differentiable kernel computes conic lit fits (the JAX "
            "package fits them through its XLA scan, having no backward of "
            "its in-kernel lighting): mode='scan' fits them")
    if num_intervals > MAX_INTERVALS:
        raise NotImplementedError(
            f"the differentiable march takes at most {MAX_INTERVALS} TF "
            f"intervals, got {num_intervals}: mode='scan' fits more")


def check_light_fit_supported(config: RenderConfig, channels: int,
                              num_intervals: int, light) -> None:
    """What a fit of the light parameters adds to
    :func:`check_diff_supported` (cf. ``diff_pallas_light_eligible``): an
    a1 render with ortho rays, no LUT and a uniform light colour; the rest
    raises NotImplementedError naming ``mode='scan'``, which fits it (the
    JAX package's XLA scan does)."""
    if config.algorithm is not Algorithm.VRC or (
            config.interp is not Interp.NEAREST) or channels > 1:
        raise NotImplementedError(
            "no differentiable kernel computes light fits of a5, smooth, "
            "Interp.TRILINEAR_COLOR or 4-D renders (the JAX package fits "
            "them through its XLA scan): mode='scan' fits them")
    check_diff_supported(config, channels, num_intervals)
    if config.conic:
        raise NotImplementedError(
            "no differentiable kernel computes conic light fits (the JAX "
            "package fits them through its XLA scan): mode='scan' fits them")
    if config.tf_lut:
        raise NotImplementedError(
            "a light fit through a LUT is not computed by the fused marches "
            "(the JAX package's kernels refuse it too, "
            "pallas_march_vjp.py:1661-1664): mode='scan' fits it")
    if config.scattering:
        raise NotImplementedError(
            "no differentiable kernel computes light fits of scattered "
            "renders (the JAX package fits a traced light of a scattered "
            "render through its XLA scan): mode='scan' fits them")
    if not phong.uniform_light(light):
        raise NotImplementedError(
            "the baked march shades with one light colour: mode='scan' fits "
            "from a light colour that is not uniform, shading each channel "
            "with its own")


def check_scatter_fit_supported(config: RenderConfig, channels: int,
                                num_intervals: int, light=None) -> None:
    """What a fit of a scattered render adds to :func:`check_diff_supported`
    (cf. ``diff_pallas_scatter_eligible``, pallas_march_vjp.py:1333-1366):
    an a1 nearest-voxel render with ortho rays, no LUT and a static light
    of a uniform colour (the default one where ``light`` is None); the rest
    raises NotImplementedError naming ``mode='scan'``, which fits it."""
    if config.algorithm is not Algorithm.VRC or (
            config.interp is Interp.TRILINEAR):
        raise NotImplementedError(
            "no differentiable kernel computes scattered fits of a5 or smooth "
            "renders (the JAX package's a5 and smooth diff kernels exclude "
            "scattering, and it fits them through its XLA scan): mode='scan' "
            "fits them")
    check_diff_supported(config, channels, num_intervals)
    what = None
    if config.conic:
        what = "conic scattered fits"
    elif config.tf_lut:
        what = "scattered fits through a LUT"
    elif light is not None and any(t.requires_grad for t in light.fields()):
        what = "light fits of scattered renders"
    elif not phong.uniform_light(light):
        what = "scattered fits under a non-uniform light colour"
    if what is not None:
        raise NotImplementedError(
            f"no differentiable kernel computes {what} (the JAX package fits "
            "them through its XLA scan): mode='scan' fits them")


def diff_eligible(volume, tf: TransferFunction, config: RenderConfig) -> bool:
    """True when :func:`render_vrc_diff` computes this render
    (cf. ``diff_pallas_eligible``): a1 classify by intervals or a LUT, lit
    (ortho) or not, one channel, nearest-voxel sampling, at most 16
    intervals; scattered renders as :func:`diff_scatter_eligible` says."""
    if config.scattering:
        return diff_scatter_eligible(volume, tf, config)
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


def diff_scatter_eligible(volume, tf: TransferFunction,
                          config: RenderConfig, light=None) -> bool:
    """True when :func:`render_vrc_scatter_diff` fits this scattered render
    (cf. ``diff_pallas_scatter_eligible``)."""
    if not config.scattering:
        return False
    try:
        check_scatter_fit_supported(config, volume.channels,
                                    tf.num_intervals, light)
    except NotImplementedError:
        return False
    return True


def prepare_diff(volume, tf: TransferFunction, camera, config: RenderConfig,
                 bake: bool = True, **unit) -> Tuple[MarchArgs, torch.Tensor]:
    """(march args at eps 0 and density 1, the colours with the static
    ``density_scale`` folded into alpha).  The colours keep their autograd
    history; the args are built from a detached copy: with lighting the
    baked (M, S) of the default light (``bake=False`` leaves them to the
    caller, as a light fit bakes its own), with ``tf_lut`` the uint16
    LUT-index grid and ``itv``, the interval of every LUT entry, beside the
    TF's own colours.  ``unit`` holds the work-unit keywords of
    ``march.prepare``; a lit slab's (M, S) are the whole volume's bake
    cropped to its planes, as the JAX package's halo-extended slab bake
    gives them (render_dist.py:433-456)."""
    check_diff_supported(config, volume.channels, tf.num_intervals)
    colors = tf.colors.to(volume.data.device)
    if config.density_scale != 1.0:
        # pallas_march_vjp.py:1682-1687: a_k -> clip(a_k * density, 0, 1)
        alpha = clip01(colors[:, 3:4] * np.float32(config.density_scale))
        colors = torch.cat([colors[:, :3], alpha], dim=1)
    with torch.no_grad():
        tf_fixed = TransferFunction(tf.lower, tf.upper, colors.detach(),
                                    tf.hg_g)
        cfg = config.replace(density_scale=1.0,
                             lighting=config.lighting and bake)
        grids = None
        slab_x = unit.get("slab_x") or 0
        if slab_x and cfg.lighting:
            x0 = unit.get("x0", 0)
            cal = torch.trunc(volume.cal_max.to(_f32))
            grids = tuple(g[x0:x0 + slab_x].contiguous() for g in
                          march.bake_grids(volume, tf_fixed, camera, cfg,
                                           None, cal, cal))
        args = march.prepare(volume, tf_fixed, camera, cfg, 0.0,
                             baked_grids=grids, **unit)
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
                    g_t: torch.Tensor, per_ray: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel -> dL/dcolors [K, 4]:
    the kernel's two passes with its float order, as a loop over samples
    vectorised over rays, in every variant (interval ids or LUT indices,
    baked light or not, a 4-D volume's channel grids) and over a work
    unit's columns, samples and x-slab, where ``g_t`` is the cotangent of
    the unit's own final T and a sample that another slab owns is the over
    identity, in no interval's sums.  Each ray sums its terms per interval
    in sample order; the rays' sums are added last.  With ``per_ray`` the
    same float32 terms are summed per ray in float64 and not over the rays
    -> [W * H, K, 4] float64 (ray px * H + py): the sums that any float
    order of the terms approximates."""
    if a.density_scale != 1.0:
        raise ValueError("fold density_scale into the colours first "
                         "(prepare_diff)")
    lut = a.ids.dtype == torch.uint16
    if lut != (a.itv is not None):
        raise ValueError("LUT indices need itv, interval ids none")
    dev = a.ids.device
    o, d = march._rays(a, a.x_offset, a.full_width)
    ids_at = march._sample_ids(a, o, d)
    colors = a.colors
    k = colors.shape[0]
    itv = a.itv.long() if lut else None
    baked = a.mgrid is not None
    mc = a.chans is not None
    one = torch.ones((), dtype=_f32, device=dev)
    zero_f = torch.zeros((), dtype=_f32, device=dev)
    if baked:
        mflat, sflat = a.mgrid.reshape(-1), a.sgrid.reshape(-1)
    if mc:
        cflat = a.chans.reshape(a.chans.shape[0], -1)
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]

    def sample(i):
        """(interval, alpha, g . c', M, owned) of every ray's sample i;
        alpha 0 where another slab owns it (owned None off a slab)."""
        sid, valid, flat, ijk = ids_at(i)
        mid = itv[sid] if lut else sid
        rgba = colors[mid]
        owned = march.owned_by(a, ijk) if a.slab_x else None
        r, g, b = rgba[..., 0], rgba[..., 1], rgba[..., 2]
        m = None
        if baked:  # c' = c * M + S; off the volume M = 1, S = 0
            m = torch.where(valid, mflat[flat], one)
            sh = torch.where(valid, sflat[flat], zero_f)
            r, g, b = r * m + sh, g * m + sh, b * m + sh
        elif mc:  # c' = the channel rgb; 0 off the volume
            ch = torch.where(valid, cflat[:, flat], zero_f)
            r, g, b = (ch[0],) * 3 if ch.shape[0] == 1 else ch
        gd = (gr * r + gg * g) + gb * b
        alpha = rgba[..., 3]
        if owned is not None:
            alpha = torch.where(owned, alpha, zero_f)
        return mid, alpha, gd, m, owned

    shape = (a.width, a.height)
    samples = range(a.s_start, a.s_start + a.spr)
    t = torch.ones(shape, dtype=_f32, device=dev)
    total = torch.zeros(shape, dtype=_f32, device=dev)
    for i in samples:  # pass A
        _, alpha, gd, _, _ = sample(i)
        w = t * alpha
        total = total + w * gd
        t = t * (1.0 - alpha)
    bg_term = t * g_t

    acc = torch.zeros((a.width * a.height, k, 4),
                      dtype=torch.float64 if per_ray else _f32, device=dev)
    zero = torch.zeros((), dtype=_f32, device=dev)
    t = torch.ones(shape, dtype=_f32, device=dev)
    pfx = torch.zeros(shape, dtype=_f32, device=dev)
    for i in samples:  # pass B
        mid, alpha, gd, m, owned = sample(i)
        w = t * alpha
        pfx = pfx + w * gd
        suffix = total - pfx
        denom = 1.0 - alpha
        num = suffix + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        t = t * denom
        if mc:  # channel rgb is data: the rgb columns stay exactly 0
            terms = torch.stack([zero.expand(shape)] * 3 + [da], dim=-1)
        else:
            wm = w * m if baked else w  # dC/dc = w M
            terms = torch.stack([wm * gr, wm * gg, wm * gb, da], dim=-1)
        if owned is not None:  # another slab's sample: no interval's
            terms = torch.where(owned[..., None], terms, zero)
        acc.scatter_add_(1, mid.reshape(-1, 1, 1).expand(-1, 1, 4),
                         terms.reshape(-1, 1, 4).to(acc.dtype))
    return acc if per_ray else acc.sum(dim=0)


def num_blocks(width: int, height: int) -> int:
    """Rows of the kernel's partials: one per block of BLOCK_X x BLOCK_Y
    pixels."""
    return -(-width // BLOCK_X) * -(-height // BLOCK_Y)


def block_sums(per_ray: torch.Tensor, width: int, height: int,
               block_x: int = BLOCK_X, block_y: int = BLOCK_Y
               ) -> torch.Tensor:
    """Per-ray sums [W * H, K, 4] (ray px * H + py) summed over the
    kernel's blocks -> [num_blocks, K, 4] in the rows of its partials
    (block (px // block_x) * ceil(H / block_y) + py // block_y; K4's blocks
    unless given)."""
    k = per_ray.shape[1]
    x = per_ray.reshape(width, height, k, 4)
    pw, ph = -width % block_x, -height % block_y
    x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, ph, 0, pw))
    return x.reshape((width + pw) // block_x, block_x,
                     (height + ph) // block_y, block_y, k, 4
                     ).sum(dim=(1, 3)).reshape(-1, k, 4)


class SampleRange(NamedTuple):
    """Each ray's samples as K4 takes them (``bwd_spans``, csrc/march_bwd.cu),
    int64 [W, H] each.  The ray visits samples [lo, hi]: the unit's window,
    on an x-slab within the samples the slab may own (another slab's
    sample is the over identity, skipped).  Sample i there runs the full
    chain where ``chain_lo <= i <= chain_hi`` (every sample whose chain
    gives a voxel) or where it is not surely owned (``i < own_lo`` or
    ``i > own_hi``; off a slab every sample is owned); every other sample
    is owned and off the volume: the constant of id0.  The spans are
    clamped to [lo, hi]; an empty one has lo > hi."""

    lo: torch.Tensor
    hi: torch.Tensor
    chain_lo: torch.Tensor
    chain_hi: torch.Tensor
    own_lo: torch.Tensor
    own_hi: torch.Tensor

    def full(self, i: int) -> torch.Tensor:
        """bool [W, H]: whether sample i runs the full chain."""
        return (self.visits(i)
                & (((i >= self.chain_lo) & (i <= self.chain_hi))
                   | (i < self.own_lo) | (i > self.own_hi)))

    def visits(self, i: int) -> torch.Tensor:
        """bool [W, H]: whether the ray takes sample i at all."""
        return (i >= self.lo) & (i <= self.hi)


def sample_range(a: MarchArgs) -> SampleRange:
    """K4's spans of every ray of march input ``a``, as the kernel computes
    them in its float order (``bwd_spans`` in csrc/march_bwd.cu, on
    ``box_span`` in csrc/march_common.cuh).  Used to check and count the
    spans; :func:`march_bwd_plain` evaluates every sample."""
    s = a.scal
    dev = s.device
    o, d = march._rays(a, a.x_offset, a.full_width)
    ds, clip = s[march.S_DS], s[march.S_CLIP]
    shape = (a.width, a.height)
    lo = torch.full(shape, a.s_start, dtype=torch.int64, device=dev)
    hi = torch.full(shape, a.s_start + a.spr - 1, dtype=torch.int64,
                    device=dev)
    pad = march.span_pad(o, d, ds, clip)
    finite = pad >= 0.0
    in_lo, in_hi = lo, hi
    if a.slab_x:
        # the slab owns the samples whose x-clamped voxel index lies in
        # [x0, x0 + slab_x), unbounded on an outer face
        f = np.float32
        L = f(max(a.dims))
        hx = (f(L / 2) - f(a.dims[0] / 2)) + f(a.x0)  # Geom's hg[0] + x0
        leaf = f(1.0) / f(2 ** a.depth)
        inf = f(np.inf)
        olo = [hx / L - f(0.5) if a.x0 > 0 else -inf, -inf, -inf]
        ohi = [((hx + f(a.slab_x)) / L + leaf) - f(0.5)
               if a.x0 + a.slab_x < a.dims[0] else inf, inf, inf]

        def span(inward):
            return march.box_span(o, d,
                                  torch.tensor(olo, dtype=_f32, device=dev),
                                  torch.tensor(ohi, dtype=_f32, device=dev),
                                  pad, ds, clip, inward)

        a_, b_ = span(False)
        lo = torch.where(finite, torch.maximum(lo, a_), lo)
        hi = torch.where(finite, torch.minimum(hi, b_), hi)
        olo[0], ohi[0] = olo[0] + leaf, ohi[0] - leaf  # owned for sure
        a_, b_ = span(True)
        in_lo = torch.where(finite, torch.maximum(a_, lo), lo)
        in_hi = torch.where(finite, torch.minimum(b_, hi), hi)
    a_, b_ = march.box_span(o, d, s[march.S_BOX_LO:march.S_BOX_LO + 3],
                            s[march.S_BOX_HI:march.S_BOX_HI + 3], pad, ds,
                            clip, False)
    c_lo = torch.where(finite, torch.maximum(a_, lo), lo)
    c_hi = torch.where(finite, torch.minimum(b_, hi), hi)
    return SampleRange(lo, hi, c_lo, c_hi, in_lo, in_hi)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/march_bwd.cu (this tree's or another
    checkout's), with the C signature of ``vrp_march_bwd_a1`` set."""
    fn = lib.vrp_march_bwd_a1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, id_bytes, itv, lut_n, mgrid, sgrid, chans,
        # n_chans, d1, d2, d3, depth, width, height, spr, conic, x_offset,
        # full_width, s_start, x0, slab_x, g_rgb, g_t, partials, stream
        fn.argtypes = ([p, p, i, p, i, p, i, p, p, p] + [i] * 14
                       + [p, p, p, p])
        fn.restype = ctypes.c_int
    return lib


def _kernel_lib() -> ctypes.CDLL:
    return bind(_build.load("march_bwd"))


def kernel_args(a: MarchArgs, g_rgb: torch.Tensor, g_t: torch.Tensor,
                partials: torch.Tensor) -> tuple:
    """The arguments of ``vrp_march_bwd_a1`` but the stream, for march input
    ``a`` (checked by :func:`march_bwd_kernel`), its cotangents and a
    partials buffer of at least :func:`num_blocks` rows."""
    lut = a.itv is not None
    baked = a.mgrid is not None
    mc = a.chans is not None
    return (a.scal.data_ptr(), a.colors.data_ptr(), a.colors.shape[0],
            a.ids.data_ptr(), a.ids.element_size(),
            a.itv.data_ptr() if lut else None, a.itv.numel() if lut else 0,
            a.mgrid.data_ptr() if baked else None,
            a.sgrid.data_ptr() if baked else None,
            a.chans.data_ptr() if mc else None,
            a.chans.shape[0] if mc else 0,
            *a.dims, a.depth, a.width, a.height, a.spr, int(a.conic),
            a.x_offset, a.full_width or a.width, a.s_start, a.x0, a.slab_x,
            g_rgb.data_ptr(), g_t.data_ptr(), partials.data_ptr())


def march_bwd_kernel(a: MarchArgs, g_rgb: torch.Tensor,
                     g_t: torch.Tensor, per_block: bool = False
                     ) -> torch.Tensor:
    """Launch ``csrc/march_bwd.cu`` on the current stream and sum its
    per-block partials -> dL/dcolors [K, 4] (with ``per_block`` the
    partials themselves, [num_blocks, K, 4]).  The variant follows the args
    (``march.variant``): uint8 interval ids or uint16 LUT indices with
    ``itv``, with baked (M, S) grids or without, or with a 4-D volume's
    channel grids; over a work unit's columns and samples, and an x-slab
    (interval ids, plain or baked)."""
    global launches
    dev = a.ids.device
    if dev.type != "cuda":
        raise ValueError(f"march_bwd_kernel needs CUDA tensors, got {dev}")
    if a.density_scale != 1.0:
        raise ValueError("fold density_scale into the colours first "
                         "(prepare_diff)")
    lut = a.ids.dtype == torch.uint16
    baked = a.mgrid is not None
    mc = a.chans is not None
    if lut != (a.itv is not None) or baked != (a.sgrid is not None):
        raise ValueError("LUT indices need itv; mgrid and sgrid go together")
    if a.vol is not None or (mc and (lut or baked)):
        raise ValueError("the backward march has no in-kernel light, and "
                         "its channel grids go with interval ids, unlit")
    if a.slab_x and (lut or mc):
        raise ValueError("an x-slab's backward takes interval ids, plain or "
                         "baked")
    grid = (a.slab_x or a.dims[0],) + tuple(a.dims[1:])
    checks = [("scal", a.scal, _f32, (SCAL_LEN,)),
              ("colors", a.colors, _f32, None),
              ("ids", a.ids, torch.uint16 if lut else torch.uint8, grid),
              ("g_rgb", g_rgb, _f32, (a.width, a.height, 3)),
              ("g_t", g_t, _f32, (a.width, a.height))]
    if lut:
        checks.append(("itv", a.itv, torch.uint8, None))
    if baked:
        checks += [("mgrid", a.mgrid, _f32, grid),
                   ("sgrid", a.sgrid, _f32, grid)]
    if mc:
        checks.append(("chans", a.chans, _f32,
                       (a.chans.shape[0],) + tuple(a.dims)))
        if a.chans.shape[0] not in (1, 3):
            raise ValueError("chans: need 1 or 3 channel grids")
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
            *kernel_args(a, g_rgb, g_t, partials),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"backward march kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    variant_launches[march.variant(a)] += 1
    if a.segment:
        shard_launches["slab" if a.slab_x else "segment"] += 1
    return partials if per_block else partials.sum(dim=0)


def _forward(a: MarchArgs):
    """K1 on CUDA tensors, its plain version on CPU tensors -> the image,
    or a unit's (C, T) pair."""
    a = _fwd_args(a)
    return march.march_kernel(a) if a.ids.is_cuda else march.march_plain(a)


def _backward(a: MarchArgs, g_rgb: torch.Tensor,
              g_t: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if a.ids.is_cuda:
        return march_bwd_kernel(a, g_rgb, g_t)
    return march_bwd_plain(a, g_rgb, g_t)


def _cotangents(a: MarchArgs, g: torch.Tensor,
                g_t: torch.Tensor | None = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(g_rgb [W, H, 3], g_t [W, H]): of a whole render, the image
    cotangent's rgb part and the cotangent of T_N through rgb = C + T_N * bg
    (alpha is 1); of a unit, the cotangents of its C and its final T."""
    if a.segment:
        return g.contiguous(), g_t[..., 0].contiguous()
    bg = a.scal[S_BG:S_BG + 3]
    g_rgb = g[..., :3].contiguous()
    g_t = ((g_rgb[..., 0] * bg[0] + g_rgb[..., 1] * bg[1])
           + g_rgb[..., 2] * bg[2])
    return g_rgb, g_t


class _MarchFn(torch.autograd.Function):
    """colors [K, 4] -> image [W, H, 4], or a unit's (C [w, H, 3], T [w, H,
    1]), through the forward march at eps 0; the backward march gives
    dL/dcolors."""

    @staticmethod
    def forward(ctx, colors: torch.Tensor, a: MarchArgs):
        a = a._replace(colors=colors.detach().to(_f32).contiguous())
        ctx.args = a
        return _forward(a)

    @staticmethod
    def backward(ctx, *g: torch.Tensor):
        a = ctx.args
        return _backward(a, *_cotangents(a, *g)), None


def light_grad(a: MarchArgs, g_rgb: torch.Tensor, grad: torch.Tensor,
               light_vec: torch.Tensor, view_dir: torch.Tensor
               ) -> torch.Tensor:
    """dL/dlight_vec [10] of a baked march ``a`` (cf. ``_make_lit_core``):
    <g, C(dM_p, dS_p)> - <g, C(0, 0)> per parameter p, with (dM_p, dS_p)
    the bake's tangents on the gradient field ``grad`` and C the march's
    colour sum (the background off; a unit's C), 11 forward marches in
    all."""
    dm, ds = phong.bake_tangents(None, None, light_vec, view_dir, grad=grad)
    scal = a.scal.clone()
    scal[S_BG:S_BG + 3] = 0.0  # out = C
    t = a._replace(scal=scal)

    def dot(mg, sg):
        out = _forward(t._replace(mgrid=mg, sgrid=sg))
        return (g_rgb * (out[0] if a.segment else out[..., :3])).sum()

    zero = torch.zeros_like(a.mgrid)
    oov = dot(zero, zero)  # the off-volume samples' constant (1, 0)
    return torch.stack([dot(dm[p], ds[p]) - oov
                        for p in range(phong.N_LIGHT_PARAMS)])


class _LitMarchFn(torch.autograd.Function):
    """(colors [K, 4], light_vec [10]) -> image [W, H, 4], or a unit's (C,
    T) on the rays and samples axes: the bake of the light vector on the
    gradient field ``grad``, then the baked forward march at eps 0; the
    backward march gives dL/dcolors and :func:`light_grad`
    dL/dlight_vec."""

    @staticmethod
    def forward(ctx, colors: torch.Tensor, light_vec: torch.Tensor,
                a: MarchArgs, grad: torch.Tensor, view_dir: torch.Tensor):
        light_vec = light_vec.detach().to(_f32)
        mgrid, sgrid = phong.bake_light_vec(grad, light_vec, view_dir)
        a = a._replace(colors=colors.detach().to(_f32).contiguous(),
                       mgrid=mgrid, sgrid=sgrid)
        ctx.args, ctx.grad, ctx.view_dir = a, grad, view_dir
        ctx.light_vec = light_vec
        return _forward(a)

    @staticmethod
    def backward(ctx, *g: torch.Tensor):
        a = ctx.args
        g_rgb, g_t = _cotangents(a, *g)
        dcolors = dlight = None
        if ctx.needs_input_grad[0]:
            dcolors = _backward(a, g_rgb, g_t)
        if ctx.needs_input_grad[1]:
            dlight = light_grad(a, g_rgb, ctx.grad, ctx.light_vec,
                                ctx.view_dir)
        return dcolors, dlight, None, None, None


def _tangents(fn, primal: torch.Tensor, units) -> torch.Tensor:
    """``torch.func.jvp`` of ``fn`` at ``primal`` along each one-hot
    tangent (an index of ``primal`` per entry of ``units``), all at once
    under ``vmap`` -> [len(units), *fn's shape]."""
    basis = torch.zeros((len(units),) + tuple(primal.shape), dtype=_f32,
                        device=primal.device)
    for i, u in enumerate(units):
        basis[(i,) + tuple(u)] = 1.0

    def tangent(e):
        return torch.func.jvp(fn, (primal,), (e,))[1]

    with torch.no_grad():
        return torch.func.vmap(tangent)(basis)


class _ScatterMarchFn(torch.autograd.Function):
    """(colors [K, 4], hg_g [K']) -> image [W, H, 4]: the S grid of
    ``s_of(colors, hg_g)`` (the light's S plus the scatter bake), then the
    baked forward march at eps 0; the backward march at that S gives the
    direct dL/dcolors, and tangent marches the alpha column's (and
    ``hg_g``'s) part through S."""

    @staticmethod
    def forward(ctx, colors: torch.Tensor, hg: torch.Tensor, a: MarchArgs,
                s_of) -> torch.Tensor:
        colors = colors.detach().to(_f32).contiguous()
        hg = hg.detach().to(_f32)
        with torch.no_grad():
            sgrid = s_of(colors, hg).contiguous()
        a = a._replace(colors=colors, sgrid=sgrid)
        ctx.args, ctx.s_of, ctx.hg = a, s_of, hg
        return _forward(a)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, s_of, hg = ctx.args, ctx.s_of, ctx.hg
        g_rgb, g_t = _cotangents(a, g)
        k = a.colors.shape[0]
        need_c, need_hg = ctx.needs_input_grad[:2]
        scal = a.scal.clone()
        scal[S_BG:S_BG + 3] = 0.0  # out = C
        t = a._replace(scal=scal)

        def dot(sg):
            return (g_rgb * _forward(t._replace(sgrid=sg))[..., :3]).sum()

        base = dot(torch.zeros_like(a.sgrid))  # the shared S -> 0 march
        dcolors = dhg = None
        if need_c:
            dcolors = _backward(a, g_rgb, g_t)
            ds = _tangents(lambda c: s_of(c, hg), a.colors,
                           [(p, 3) for p in range(k)])
            dcolors[:, 3] += torch.stack([dot(ds[p].contiguous()) - base
                                          for p in range(k)])
        if need_hg:
            ds = _tangents(lambda h: s_of(a.colors, h), hg,
                           [(p,) for p in range(k)])
            dhg = torch.zeros_like(hg)
            dhg[:k] = torch.stack([dot(ds[p].contiguous()) - base
                                   for p in range(k)])
        return dcolors, dhg, None, None


def render_vrc_scatter_diff(volume, tf: TransferFunction, camera,
                            config: RenderConfig, *, device=None,
                            light: phong.Light | None = None
                            ) -> torch.Tensor:
    """a1/VRC render with single scattering -> [W, H, 4] (alpha 1),
    differentiable with respect to ``tf.colors`` and ``tf.hg_g`` through
    the baked forward march (K1) and backward march (K4) plus 1 + K
    tangent marches of K1 baked (K more for ``hg_g``) on ``device`` (CUDA
    unless given); CPU tensors take their plain versions
    (cf. ``render_vrc_pallas_diff_scatter``).  ``light`` is static: the
    default light unless given.  Equal in value to ``render(...)`` at
    ``early_termination=0``."""
    dev = resolve_device(device)
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    check_scatter_fit_supported(config, volume.channels, tf.num_intervals,
                                light)
    light = phong.default_light(dev) if light is None else light.to(dev)
    args, colors = prepare_diff(volume, tf, camera,
                                config.replace(scattering=False), bake=False)
    with torch.no_grad():
        if config.lighting:
            mgrid, s_light = phong.bake_light_grids(volume.data, config, light,
                                                    -camera.front)
        else:
            mgrid = torch.ones(volume.dims, dtype=_f32, device=dev)
            s_light = torch.zeros(volume.dims, dtype=_f32, device=dev)
        cal_trunc = torch.trunc(volume.cal_max.to(_f32))
    # the colours carry the density fold already: the bake runs at 1
    bake_cfg = config.replace(density_scale=1.0)
    lower, upper = tf.lower.detach(), tf.upper.detach()
    sweep = phong.sweep_axis(light.direction)

    def s_of(c, hg):
        tf2 = TransferFunction(lower, upper, c, hg)
        return s_light + phong.bake_scatter_grid(
            volume.data, tf2, bake_cfg, light, camera.front, cal_trunc,
            cal_trunc, sweep)

    return _ScatterMarchFn.apply(colors, tf.hg_g, args._replace(
        mgrid=mgrid.contiguous()), s_of)


def render_vrc_diff(volume, tf: TransferFunction, camera,
                    config: RenderConfig, *, device=None,
                    light: phong.Light | None = None, **unit):
    """a1/VRC render -> [W, H, 4] (alpha 1), differentiable with respect to
    ``tf.colors`` through the forward march (K1) and the backward march
    (K4) on ``device`` (CUDA unless given); CPU tensors take their plain
    versions.  Lit configs shade with the default light's baked grids, LUT
    configs classify through ``tf.to_lut``; on a 4-D volume only the alpha
    column gets a gradient (rgb is the data's; :func:`check_mc_fit_supported`
    says which configs).  With ``light``, the render is
    shaded with it and differentiable with respect to its fields too
    (:func:`check_light_fit_supported`).  Equal in value to
    ``render(..., mode="scan")``; the gradient equals autograd through that
    scan except where a sample's alpha is exactly 1 (see the module
    docstring).  Scattered configs differentiate through
    :func:`render_vrc_scatter_diff`, with ``light`` static.

    With ``unit``, the keywords of ``march.prepare`` that select a sharded
    fit's work unit (``segment=True``), it returns the unit's (C [w, H,
    3], T [w, H, 1]) pair (``render_vrc_pallas_diff_segment``,
    pallas_march_vjp.py:1854), differentiable through its cotangents;
    ``parallel/render_dist.py`` says which units the kernels take."""
    if config.scattering:
        if unit:
            raise NotImplementedError(
                "no differentiable work unit computes sharded scattered fits "
                "(the JAX package fits them through its XLA scan segments): "
                "mode='scan' fits them")
        return render_vrc_scatter_diff(volume, tf, camera, config,
                                       device=device, light=light)
    dev = resolve_device(device)
    volume, tf, camera = volume.to(dev), tf.to(dev), camera.to(dev)
    if light is None:
        args, colors = prepare_diff(volume, tf, camera, config, **unit)
        return _MarchFn.apply(colors, args)
    if unit.get("slab_x"):
        raise NotImplementedError(
            "no differentiable slab unit takes an explicit light (the JAX "
            "package fits it through its slab scan): mode='scan' fits it")
    light = light.to(dev)
    check_light_fit_supported(config, volume.channels, tf.num_intervals,
                              light)
    args, colors = prepare_diff(volume, tf, camera, config, bake=False,
                                **unit)
    with torch.no_grad():
        grad = conv3d.gradient_field(volume.data, config.gradient_filter,
                                     config.presmooth_sigma)
    return _LitMarchFn.apply(colors, phong.light_to_vec(light), args, grad,
                             -camera.front)
