"""The fused a1/VRC ray march: its prep, its plain PyTorch version and the
wrapper of its CUDA kernel (``csrc/march.cu``).

Counterpart of ``volumerenderingproject_tpu/ops/pallas_march.py`` in resident
mode, and in its streamed modes too (``render_vrc_pallas_streamed``, for
volumes beyond the TPU's VMEM): the volume stays in device memory at every
size.  Ortho or conic rays, nearest-voxel sampling, classification by the
interval scan or a dense LUT (``config.tf_lut``), Blinn-Phong shading
(``config.lighting``) baked (ortho, a uniform light colour) or in the
kernel (conic rays or any light colour), single scattering
(``config.scattering``, ortho), 4-D multichannel volumes, ``density_scale``,
front-to-back (C, T) compositing and early ray termination.

The a1 pipeline uses a voxel's intensity only through the transfer function
(kernel.cu:64-67), so the march reads a per-voxel **colour-id grid** and
looks the RGBA up by id: a uint8 interval id (the TF's last-match-wins index
of ``max(v, 0) / trunc(cal_max)``), or with ``tf_lut`` a uint16 LUT index
(``round(vn * (N - 1))``, clipped; raycast.py:186-192).  The ids are exact,
so the result equals a march over intensities.  Prep (per call, plain
PyTorch):

  * :func:`material_ids` or :func:`lut_ids`: the id grid and ``id0``, the id
    of intensity 0, which every sample off the volume takes (0 for a LUT);
  * :func:`brick_occupancy`: 1 per 8³ brick holding any voxel of alpha != 0;
  * ``ops/phong.bake_light_grids``: with lighting on ortho rays and a
    uniform light colour, the per-voxel factors (M, S) such that a sample's
    shaded colour is ``rgb * M + S`` (pallas_march.py:1225-1270).  The view
    direction ``-camera.front`` is the same for every ortho ray, so every
    input of the shading is a per-voxel quantity; the bake is rebuilt for
    every frame;
  * :func:`light_vector`: with lighting on conic rays or under a light
    colour that is not uniform, the in-kernel variant's light [10]
    (pallas_march.py:1652-1667) beside the raw f32 volume, whose central
    differences (0 past a face) are the normals (pallas_march.py:503-620).
    It takes the central filter at presmooth 0 only, as the JAX kernel does;
  * ``ops/phong.bake_scatter_grid``: with scattering, the per-voxel
    single-scattered radiance, added to S (M = 1, S = 0 where unlit;
    pallas_march.py:1685-1692): ortho rays share the direction
    ``camera.front``, and the a1 material lookup and the transmittance's
    alpha both normalise by trunc(cal_max);
  * :func:`mc_grids`: for a 4-D volume [X, Y, Z, C], the interval ids of
    the channel mean of ``max(v, 0) / cal_max`` (the float cal_max) for
    alpha, and 1 (C = 2, grey) or 3 normalised channel grids for rgb
    (pallas_march.py:1612-1641); no lighting, LUT or scattering there;
  * :func:`scal_vector`: camera, screen, box and TF scalars for the kernel.

A sharded render (``parallel/render_dist.py``) marches one work unit per
rank (pallas_march.py:1837 ``render_vrc_pallas_segment``): columns
[x_offset, x_offset + local_width) of the image, samples [s_start, s_start
+ s_count) of each ray, and on the mesh's volume axis the x-slab [x0, x0 +
slab_x) of the voxel grid, returning the raw front-to-back (C, T) pair
without the background.  Rays keep their global column and samples their
global index.  A slab's id grid, brick map and channel grids hold its own
planes only (trunc(cal_max) stays the whole volume's), and every sample
belongs to the slab that holds its x-clamped voxel index, off the volume
too (sampling.py:105-140), so that each sample is composited by one slab;
the others leave (C, T) as it is.  The box clip's x extent shrinks to the
slab (pallas_march.py:1717-1724).  A slab takes baked (M, S) only from the
differentiable march (``ops/march_vjp.prepare_diff``), which bakes them on
the whole volume and crops them to the slab: the normals cross the slab's
faces.

Every skip the kernel makes is exact: a skipped sample has alpha exactly 0
and leaves (C, T) unchanged.  A negative alpha (a fit can drive one below
0) changes T, so it counts as occupied.  When TF(0).alpha != 0 (samples off
the volume change the image) or ``config.empty_space_skipping`` is off, the
kernel marches every sample.  Early termination stops a ray before the
first sample at which |T| <= eps, which changes the output by at most eps
times the largest colour (a sample of alpha above 1, which a fit can reach,
makes T negative, and the ray goes on); :func:`march_plain` stops at the same sample.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import transforms as T
from ..utils.config import Interp, RenderConfig
from . import _build
from .phong import (Light, bake_light_grids, bake_scatter_grid,
                    check_scatter_channels, default_light, is_lit,
                    light_to_vec, norm3, uniform_light)

_f32 = torch.float32
BRICK = 8
# the kernel keeps the colours in shared memory: interval ids are uint8, LUT
# indices uint16 (the JAX kernel's limit, pallas_march.py:1419)
MAX_INTERVALS = 256
MAX_LUT = 1024

# slots of the kernel's scalar vector
S_DS, S_CLIP, S_CAL_MAX, S_EPS, S_FULL = 0, 1, 2, 3, 4
S_POS, S_FRONT, S_RIGHT, S_UP, S_TL = 5, 8, 11, 14, 17
S_RSW, S_RSH, S_BOX_LO, S_BOX_HI, S_ID0, S_BG = 20, 21, 22, 25, 28, 29
SCAL_LEN = 32

# launches of the CUDA kernel since import (or since a caller reset them),
# in all and by variant (:func:`variant`)
launches = 0
variant_launches = {"plain": 0, "lut": 0, "baked": 0, "lut_baked": 0,
                    "lit": 0, "lut_lit": 0, "mc": 0}
# and the launches that marched a sharded render's work unit: a segment
# over the whole volume, or one on an x-slab of it
shard_launches = {"segment": 0, "slab": 0}


class MarchArgs(NamedTuple):
    """Everything one march needs, on one device."""

    scal: torch.Tensor  # [32] f32
    colors: torch.Tensor  # [K, 4] f32: the TF's colours, or its LUT
    ids: torch.Tensor  # [X, Y, Z] uint8 interval ids, or uint16 LUT indices
    occ: torch.Tensor  # [nbx * nby * nbz] int32
    nbricks: Tuple[int, int, int]
    dims: Tuple[int, int, int]
    depth: int
    width: int
    height: int
    spr: int
    conic: bool
    density_scale: float
    # [X, Y, Z] f32 baked M and S (of the slab's planes on a slab), lit or
    # scattered only
    mgrid: Optional[torch.Tensor] = None
    sgrid: Optional[torch.Tensor] = None
    # [N] uint8: the TF interval of each LUT entry (``lut_intervals``); set
    # by the differentiable march, whose ``colors`` are then the TF's [K, 4]
    itv: Optional[torch.Tensor] = None
    # in-kernel lighting: the raw [X, Y, Z] f32 volume and the light [10]
    vol: Optional[torch.Tensor] = None
    lvec: Optional[torch.Tensor] = None
    # 4-D volumes: [G, X, Y, Z] f32 normalised channels for rgb (G = 1, grey,
    # or 3); ``ids`` then holds the interval ids of the channel mean
    chans: Optional[torch.Tensor] = None
    # a sharded render's work unit: columns [x_offset, x_offset + width) of
    # a full_width-wide image (0: width), samples [s_start, s_start + spr);
    # with slab_x > 0 the grids hold x-planes [x0, x0 + slab_x) of the dims
    # volume; ``segment`` returns (C, T) without the background
    x_offset: int = 0
    full_width: int = 0
    s_start: int = 0
    x0: int = 0
    slab_x: int = 0
    segment: bool = False


def material_ids(data: torch.Tensor, tf, cal_max_trunc: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids uint8 [X, Y, Z], id0 int64 scalar): the TF interval index of
    every voxel under a1 value semantics (negatives clamped, divided by
    trunc(cal_max); kernel.cu:42,64-66), and the index of intensity 0."""
    k = tf.num_intervals
    if k > MAX_INTERVALS:
        raise ValueError(f"the id grid holds at most {MAX_INTERVALS} "
                         f"intervals, got {k}")
    ids = tf.classify_index(data.clamp_min(0.0) / cal_max_trunc)
    id0 = tf.classify_index(torch.zeros((), dtype=_f32, device=data.device))
    return ids.to(torch.uint8), id0


def lut_ids(data: torch.Tensor, lut_n: int,
            cal_max_trunc: torch.Tensor) -> torch.Tensor:
    """uint16 [X, Y, Z]: every voxel's index into an ``lut_n``-entry LUT,
    ``clip(round(max(v, 0) / trunc(cal_max) * (lut_n - 1)))`` (the
    counterpart of ``pack_lut_grid``, pallas_march.py:1195-1222).  An
    intensity of 0 takes index 0, which is the off-volume id."""
    if not 0 < lut_n <= MAX_LUT:
        raise ValueError(f"tf_lut size {lut_n} not in (0, {MAX_LUT}]")
    vn = data.clamp_min(0.0) / cal_max_trunc
    idx = torch.round(vn * np.float32(lut_n - 1)).clamp(0, lut_n - 1)
    return idx.to(torch.uint16)


def channel_mean(norm: torch.Tensor) -> torch.Tensor:
    """The mean over the last (channel) axis as ``jnp.mean`` computes it on
    the CPU, ``((n0 + n1) + n2 ...) * f32(1 / C)`` (XLA multiplies by the
    reciprocal; ``torch.mean`` divides, an ulp off at C = 3): a mean an ulp
    apart could cross a TF bound and change a voxel's interval."""
    total = norm[..., 0]
    for c in range(1, norm.shape[-1]):
        total = total + norm[..., c]
    return total * torch.tensor(np.float32(1.0 / norm.shape[-1]),
                                device=norm.device)


def mc_grids(volume, tf) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ids uint8 [X, Y, Z], id0, chans [G, X, Y, Z] f32) of a 4-D volume
    (pallas_march.py:1612-1641): ``norm = max(v, 0) / cal_max`` with the
    float cal_max (not trunc, as in the multichannel sampler,
    raycast.py:272-301), the interval ids of its channel mean at
    normalisation 1, and the rgb grids: channels 0-2, or channel 0 alone
    (grey) for C = 2."""
    cal = volume.cal_max.to(device=volume.data.device, dtype=_f32)
    norm = volume.data.clamp_min(0.0) / cal
    ids, id0 = material_ids(channel_mean(norm), tf,
                            torch.ones((), dtype=_f32, device=cal.device))
    g = 1 if volume.channels < 3 else 3
    return ids, id0, norm[..., :g].permute(3, 0, 1, 2).contiguous()


def light_vector(light: Light) -> torch.Tensor:
    """The in-kernel lighting variant's light [10] f32
    (pallas_march.py:1652-1667): the unit direction (its length taken in
    float64 and rounded once, as ``phong.norm3``), the colour, ambient,
    diffuse, specular and shininess."""
    v = light_to_vec(light)
    return torch.cat([v[:3] / norm3(v[:3]), v[3:]]).contiguous()


def brick_occupancy(ids: torch.Tensor, table: torch.Tensor,
                    brick: Tuple[int, int, int] = (BRICK, BRICK, BRICK)
                    ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """([nbx*nby*nbz] int32, (nbx, nby, nbz)): 1 where any voxel of the
    brick has alpha != 0 (before ``density_scale``) in ``table``, the
    [N, 4] colours its ids index (the TF's colours, or its LUT)."""
    alpha_nz = table[:, 3] != 0.0
    occ = alpha_nz[ids.long()]
    dims = tuple(ids.shape)
    nb = tuple(-(-d // b) for d, b in zip(dims, brick))
    pad = []
    for c in (2, 1, 0):
        pad += [0, nb[c] * brick[c] - dims[c]]
    occ = torch.nn.functional.pad(occ.to(torch.uint8), pad)
    occ = occ.reshape(nb[0], brick[0], nb[1], brick[1], nb[2], brick[2])
    occ = occ.amax(dim=(1, 3, 5))
    return occ.reshape(-1).to(torch.int32), nb


def _box(dims, depth, x0: int = 0, slab_x: int = 0):
    """Dataset box in ray space (p = pos + 0.5 in [hg/L, (hg+dim)/L + 1/n]),
    intersected with the root cube, conservative by half a voxel
    (pallas_march.py:1709-1716); with ``slab_x``, its x extent tightened to
    planes [x0, x0 + slab_x) in the JAX package's float32 order
    (pallas_march.py:1717-1724)."""
    L = float(max(dims))
    n = float(2**depth)
    lo = [max(0.0, (L / 2 - d / 2) / L) - 0.5 for d in dims]
    hi = [min(1.0, (L / 2 + d / 2) / L + 1.0 / n) - 0.5 for d in dims]
    if slab_x:
        f = np.float32
        hx = (f(L / 2) - f(dims[0] / 2)) + f(x0)
        lo[0] = float(max(f(lo[0]), hx / f(L) - f(0.5)))
        hi[0] = float(min(f(hi[0]), ((hx + f(slab_x)) / f(L) + f(1.0 / n))
                          - f(0.5)))
    return lo, hi


# the spans' pad (csrc/march_common.cuh kRangePad) and empty span; the
# kernel's clip is box_span of the box in scal (K4's chain span off a slab)
RANGE_PAD = 2.0 ** -14
NO_SAMPLE = 1_000_000_000


def span_pad(o: torch.Tensor, d: torch.Tensor, ds: torch.Tensor,
             clip: torch.Tensor) -> torch.Tensor:
    """``span_pad`` (csrc/march_common.cuh) of rays ``o``, ``d`` [W, H, 3]
    -> [W, H] f32: RANGE_PAD (max |o_c| + |clip| + 2), or -1 where the ray,
    the step or the clip is not finite or the step is not positive."""
    finite = (torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
              & bool(ds > 0.0 and torch.isfinite(ds)
                     and torch.isfinite(clip)))
    pad = RANGE_PAD * ((o.abs().amax(-1) + clip.abs()) + 2.0)
    return torch.where(finite, pad, -1.0)


def box_span(o: torch.Tensor, d: torch.Tensor, lo, hi, pad: torch.Tensor,
              ds: torch.Tensor, clip: torch.Tensor, inward: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``box_span`` (csrc/march_common.cuh) in its float order: the samples
    [i_lo, i_hi] of rays ``o``, ``d`` [W, H, 3] that may lie in (``inward``:
    surely lie in) the box ``lo``, ``hi`` [3] (f32, an infinite bound
    bounds nothing), widened (narrowed) by ``pad`` [W, H] (:func:`span_pad`)
    and one sample at each end -> (i_lo, i_hi) int64 [W, H], [NO_SAMPLE,
    -NO_SAMPLE] where empty."""
    pad = pad[..., None]
    lo = lo + pad if inward else lo - pad
    hi = hi - pad if inward else hi + pad
    empty = ~(hi >= lo).all(-1)
    safe = d.abs() > 1e-12
    dv = torch.where(safe, d, torch.ones_like(d))
    ta = (lo - o) / dv
    tb = (hi - o) / dv
    in_c = (o >= lo) & (o <= hi)
    inf = torch.full_like(d, float("inf"))
    lo_c = torch.where(safe, torch.minimum(ta, tb),
                       torch.where(in_c, -inf, inf))
    hi_c = torch.where(safe, torch.maximum(ta, tb),
                       torch.where(in_c, inf, -inf))
    # fmaxf / fminf: a NaN operand gives the other
    t_lo = -inf[..., 0]
    t_hi = inf[..., 0]
    for c in range(3):
        t_lo = torch.fmax(t_lo, lo_c[..., c])
        t_hi = torch.fmin(t_hi, hi_c[..., c])
    f_lo = (t_lo - clip) / ds
    f_hi = (t_hi - clip) / ds

    def index(v):  # to_int_clamped
        return torch.fmin(torch.fmax(v, v.new_tensor(-1e9)),
                          v.new_tensor(1e9)).to(torch.int64)

    if inward:
        i_lo = index(torch.ceil(f_lo)) + 1
        i_hi = index(torch.floor(f_hi)) - 1
    else:
        i_lo = index(torch.floor(f_lo)) - 1
        i_hi = index(torch.ceil(f_hi)) + 1
    miss = empty | ~(t_hi >= t_lo)
    return (torch.where(miss, NO_SAMPLE, i_lo),
            torch.where(miss, -NO_SAMPLE, i_hi))


def scal_vector(camera, config: RenderConfig, dims, depth, cal_max_trunc,
                early_eps: float, full_march: torch.Tensor,
                id0: torch.Tensor, x0: int = 0, slab_x: int = 0
                ) -> torch.Tensor:
    """The kernel's [32] f32 scalar vector (slots ``S_*`` above), built on
    the camera's device without a round trip to the host; the box clip of
    an x-slab [x0, x0 + slab_x) with ``slab_x``."""
    dev = camera.device
    top_left = camera.top_left
    if config.conic and config.conic_corrected:
        top_left = top_left + torch.tensor(
            config.viewplane_distance, dtype=_f32, device=dev) * camera.front
    box_lo, box_hi = _box(dims, depth, x0, slab_x)

    def host(vals):
        return torch.tensor(vals, dtype=_f32, device=dev)

    return torch.cat([
        host([config.sample_distance, config.front_clip]),
        cal_max_trunc.to(_f32).reshape(1),
        host([early_eps]),
        full_march.to(_f32).reshape(1),
        camera.position, camera.front, camera.right, camera.up, top_left,
        host([config.real_screen_width, config.real_screen_height]
             + box_lo + box_hi),
        id0.to(_f32).reshape(1),
        host(list(config.background[:3])),
    ])


def check_fused_supported(config: RenderConfig, light: Light | None,
                          channels: int = 1) -> str:
    """What the fused march renders -> the kernel's route for colour:
    ``"none"``, ``"baked"`` (the (M, S) bakes: lighting
    on ortho rays under a uniform light colour, and scattering), ``"lit"``
    (in-kernel lighting: conic rays or any light colour) or ``"mc"`` (a 4-D
    volume).  What it does not compute raises NotImplementedError, naming
    the ROADMAP.md item or ``mode='scan'``, which renders it: in-kernel
    lighting takes central differences at presmooth 0 only, a 4-D volume
    no lighting or LUT (the JAX package's rules, pallas_march.py:1356-1379,
    1463-1469).  (A LUT of more than 1024 entries raises in
    :func:`lut_ids`.)  Smooth mode is not this march's: a ValueError
    (``ops/smooth`` marches it).  ``Interp.TRILINEAR_COLOR`` on one channel
    raises naming ``mode='scan'``: the JAX package's kernels sample the
    nearest voxel only (raycast.py:683); a 4-D volume samples its channels
    at the nearest voxel whatever ``config.interp`` says, here as in the
    scan."""
    if config.interp is Interp.TRILINEAR:
        raise ValueError("the nearest-voxel march does not sample "
                         "Interp.TRILINEAR: ops/smooth marches smooth mode")
    lit = is_lit(config, light)
    if channels > 1:
        if config.scattering:
            check_scatter_channels(channels)
        if lit or config.tf_lut:
            raise NotImplementedError(
                "the fused multichannel march classifies the channel mean "
                "through the interval scan, unlit, as the JAX package's "
                "kernel does (pallas_march.py:1356-1379); mode='scan' renders "
                "a lit 4-D volume (and ignores a LUT there, as the JAX scan "
                "does)")
        return "mc"
    if config.interp is Interp.TRILINEAR_COLOR:
        raise NotImplementedError(
            "the fused march samples the nearest voxel, as the JAX package's "
            "kernels do (raycast.py:683); mode='scan' renders "
            "Interp.TRILINEAR_COLOR (the a5 colour mix on the a1 rays)")
    if config.scattering:
        if config.conic:
            raise NotImplementedError(
                "conic scattering in the fused march is not ported yet: "
                "ROADMAP.md item 9 (the per-ray scattering term; the JAX "
                "package takes its XLA scan there); mode='scan' renders it")
        if not uniform_light(light):
            raise NotImplementedError(
                "fused scattering rides the baked S grid, which folds one "
                "light colour, as in the JAX package (pallas_march.py:"
                "1451-1456); mode='scan' renders it")
        return "baked"
    if not lit:
        return "none"
    if not config.conic and uniform_light(light):
        return "baked"
    if config.gradient_filter != "central" or config.presmooth_sigma != 0.0:
        raise NotImplementedError(
            "in-kernel lighting (conic rays, or a light colour that is not "
            "uniform) takes central-difference normals of the raw density, "
            "as the JAX kernel does (pallas_march.py:1463-1469); other "
            "gradient filters and presmoothing need ortho rays and a uniform "
            "light colour for the bake; mode='scan' renders it")
    return "lit"


def check_slab_supported(config: RenderConfig, light: Light | None) -> None:
    """Raise NotImplementedError, naming ``mode='scan'``, for what the
    x-slab march does not compute by itself: lighting and scattering, whose
    gradients and transmittance cross the slab's faces (the JAX package
    takes its slab scan with halos there, render_dist.py:563-580; the
    port's is ``parallel/render_dist``'s slab scan).  The differentiable
    march supplies a lit slab's cropped bake instead (:func:`prepare`'s
    ``baked_grids``)."""
    if is_lit(config, light) or config.scattering:
        raise NotImplementedError(
            "lighting and scattering on the volume axis need the slab scan "
            "with x-halos: mode='scan' renders them")


def prepare(volume, tf, camera, config: RenderConfig, early_eps: float,
            light: Light | None = None, *, x_offset: int = 0,
            local_width: int | None = None, s_start: int = 0,
            s_count: int | None = None, x0: int = 0,
            slab_x: int | None = None, segment: bool = False,
            baked_grids: Tuple[torch.Tensor, torch.Tensor] | None = None
            ) -> MarchArgs:
    """Prep for one march; all tensors on the volume's device.  ``light``
    defaults to :func:`ops.phong.default_light` where the render is lit or
    scattered.  The keywords select a sharded render's work unit (this
    module's docstring): ``volume`` is the whole volume, of which a slab
    keeps planes [x0, x0 + slab_x); ``segment`` marches to (C, T).
    ``baked_grids`` are the (M, S) of a baked march, given by the caller in
    place of the bake: a lit slab's, the whole volume's bake cropped to the
    slab's planes (``ops/march_vjp.prepare_diff``)."""
    route = check_fused_supported(config, light, volume.channels)
    dev = volume.data.device
    tf = tf.to(dev)
    camera = camera.to(dev)
    cal_max_trunc = torch.trunc(volume.cal_max.to(_f32))
    d1 = volume.dims[0]
    slab_x = slab_x or 0
    if baked_grids is not None and route != "baked":
        raise ValueError("baked_grids go with a baked march (lighting on "
                         "ortho rays under a uniform light colour)")
    if slab_x:
        if baked_grids is None:
            check_slab_supported(config, light)
        if not (0 <= x0 and 0 < slab_x and x0 + slab_x <= d1):
            raise ValueError(f"slab [{x0}, {x0 + slab_x}) outside x extent "
                             f"{d1}")
    w_local = config.width if local_width is None else local_width
    s_count = config.samples_per_ray if s_count is None else s_count
    if not (0 <= x_offset and 0 < w_local and x_offset + w_local <= config.width
            and 0 <= s_start and 0 < s_count
            and s_start + s_count <= config.samples_per_ray):
        raise ValueError(
            f"columns [{x_offset}, {x_offset + w_local}) or samples "
            f"[{s_start}, {s_start + s_count}) outside the image's "
            f"{config.width} and {config.samples_per_ray}")
    # the grids hold the slab's planes only
    grid_vol = volume if not slab_x else dataclasses.replace(
        volume, data=volume.data[x0:x0 + slab_x],
        dims=(slab_x,) + tuple(volume.dims[1:]))
    chans = None
    if route == "mc":
        table = tf.colors
        ids, id0, chans = mc_grids(grid_vol, tf)
    elif config.tf_lut:
        table = tf.to_lut(config.tf_lut)
        ids = lut_ids(grid_vol.data, config.tf_lut, cal_max_trunc)
        id0 = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        table = tf.colors
        ids, id0 = material_ids(grid_vol.data, tf, cal_max_trunc)
    occ, nb = brick_occupancy(ids, table)
    alpha0 = table[id0, 3]
    if config.density_scale != 1.0:
        alpha0 = (alpha0 * np.float32(config.density_scale)).clamp(0.0, 1.0)
    full = alpha0 != 0.0
    if not config.empty_space_skipping:
        full = torch.ones_like(full)
    scal = scal_vector(camera, config, volume.dims, volume.octree_depth,
                       cal_max_trunc, early_eps, full, id0, x0, slab_x)
    mgrid = sgrid = vol = lvec = None
    if baked_grids is not None:
        mgrid, sgrid = baked_grids
    elif route == "baked":
        mgrid, sgrid = bake_grids(volume, tf, camera, config, light,
                                  cal_max_trunc, cal_max_trunc)
    elif route == "lit":
        vol = volume.data.to(_f32).contiguous()
        lvec = light_vector(default_light(dev) if light is None
                            else light.to(dev))
    return MarchArgs(
        scal=scal, colors=table.to(_f32).contiguous(), ids=ids, occ=occ,
        nbricks=nb, dims=volume.dims, depth=volume.octree_depth,
        width=w_local, height=config.height, spr=s_count,
        conic=bool(config.conic),
        density_scale=float(config.density_scale), mgrid=mgrid, sgrid=sgrid,
        vol=vol, lvec=lvec, chans=chans, x_offset=x_offset,
        full_width=config.width, s_start=s_start, x0=x0 if slab_x else 0,
        slab_x=slab_x, segment=segment)


def bake_grids(volume, tf, camera, config: RenderConfig,
               light: Light | None, cal_for_g: torch.Tensor,
               cal_max_trunc: torch.Tensor):
    """The baked (M, S) grids of a lit or scattered march, each [X, Y, Z]
    f32 (``None, None`` for neither): the Blinn-Phong factors viewed along
    ``-camera.front`` where lit (else M = 1, S = 0), plus the scattered
    radiance along ``camera.front`` in S where scattered
    (pallas_march.py:1679-1692, pallas_a5.py:981-994).  ``cal_for_g``
    normalises the material lookup of the scattering (trunc(cal_max) on a1,
    the float cal_max on a5)."""
    lit = is_lit(config, light)
    if not (lit or config.scattering):
        return None, None
    dev = volume.data.device
    lg = default_light(dev) if light is None else light.to(dev)
    if lit:
        mgrid, sgrid = bake_light_grids(volume.data, config, lg,
                                        -camera.front)
    else:
        mgrid = torch.ones(volume.dims, dtype=_f32, device=dev)
        sgrid = torch.zeros(volume.dims, dtype=_f32, device=dev)
    if config.scattering:
        sgrid = sgrid + bake_scatter_grid(volume.data, tf, config, lg,
                                          camera.front, cal_for_g,
                                          cal_max_trunc)
    return mgrid.contiguous(), sgrid.contiguous()


def _effective_colors(a: MarchArgs) -> torch.Tensor:
    colors = a.colors
    if a.density_scale != 1.0:
        alpha = (colors[:, 3:4] * np.float32(a.density_scale)).clamp(0.0, 1.0)
        colors = torch.cat([colors[:, :3], alpha], dim=1)
    return colors


def _rays(a: MarchArgs, x_offset: int = 0, full_width: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions [W, H, 3] of the kernel's rays (its ray
    setup, expression by expression; ``ray_setup`` in
    ``csrc/march_common.cuh``, which the smooth marches share too).  ``a``
    needs ``scal`` (this module's slots), ``width``, ``height`` and
    ``conic``; a shard's columns are [x_offset, x_offset + width) of a
    ``full_width``-wide image (0: ``width``)."""
    dev = a.scal.device
    s = a.scal
    w, h = a.width, a.height
    x = (torch.arange(w, dtype=_f32, device=dev)
         + float(x_offset))[:, None].expand(w, h)
    y = torch.arange(h, dtype=_f32, device=dev)[None, :].expand(w, h)
    # divide by device tensors: CUDA divides by a host scalar as a product
    # with its reciprocal, which is not the IEEE quotient the kernel takes
    size = torch.tensor([full_width or w, h], dtype=_f32, device=dev)
    xs = ((x * s[S_RSW]) / size[0])[..., None]
    ys = ((y * s[S_RSH]) / size[1])[..., None]
    xt = xs * s[S_RIGHT:S_RIGHT + 3]
    yt = ys * (-s[S_UP:S_UP + 3])
    if a.conic:
        o = s[S_POS:S_POS + 3].expand(w, h, 3)
        rd = ((s[S_TL:S_TL + 3] + xt) + yt) - s[S_POS:S_POS + 3]
        return o, T.normalize(rd)
    return (s[S_TL:S_TL + 3] + xt) + yt, s[S_FRONT:S_FRONT + 3].expand(w, h, 3)


def owned_by(a: MarchArgs, ijk: torch.Tensor) -> torch.Tensor:
    """bool [W, H]: whether ``a``'s x-slab holds the x-clamped voxel index
    of each sample (``slab_owner_x``, sampling.py:143-147)."""
    gx = ijk[..., 0].clamp(0, a.dims[0] - 1)
    return (gx >= a.x0) & (gx < a.x0 + a.slab_x)


def _sample_ids(a: MarchArgs, o: torch.Tensor, d: torch.Tensor):
    """``ids_at(i) -> (id int64 [W, H], valid bool [W, H], flat int64
    [W, H], ijk int64 [W, H, 3])``: the colour id of every ray's sample i by
    the kernel's index chain (modelAux +0.5, octree nearest voxel), whether
    it lies in the volume, its voxel's flat index in the grids (clamped
    into range) and the voxel's global indices as the chain computes them,
    off the volume too; samples off the volume take ``id0``.  On an x-slab
    a sample is valid only where the slab holds its voxel, and ``flat``
    counts from the slab's first plane."""
    dev = a.ids.device
    s = a.scal
    d1, d2, d3 = a.dims
    L = np.float32(max(a.dims))
    n = np.float32(2**a.depth)
    hg = torch.tensor([np.float32(L / 2) - np.float32(v / 2) for v in a.dims],
                      dtype=_f32, device=dev)
    hg_hi = hg + torch.tensor(a.dims, dtype=_f32, device=dev)
    halfd = torch.tensor([np.float32(v / 2) for v in a.dims], dtype=_f32,
                         device=dev)
    halfL = np.float32(L / 2)
    # int64 once: uint16 tensors take copies, not every indexing op
    ids_flat = a.ids.reshape(-1).to(torch.int64)
    id0 = s[S_ID0].to(torch.int64)
    x0, nx = (a.x0, a.slab_x) if a.slab_x else (0, d1)

    def ids_at(i: int):
        ti = torch.tensor(float(i), dtype=_f32, device=dev) * s[S_DS] + s[S_CLIP]
        p = (o + ti * d) + 0.5
        res = (torch.floor(p * n) / n) * L
        valid = (((p >= 0.0) & (p < 1.0) & (res >= hg) & (res < hg_hi))
                 .all(dim=-1))
        ijk = torch.trunc((res + halfd) - halfL).to(torch.int64)
        if a.slab_x:
            valid = valid & owned_by(a, ijk)
        flat = ((ijk[..., 0] - x0) * (d2 * d3) + ijk[..., 1] * d3
                + ijk[..., 2]).clamp(0, nx * d2 * d3 - 1)
        return torch.where(valid, ids_flat[flat], id0), valid, flat, ijk

    return ids_at


def _lit_shade(a: MarchArgs, d: torch.Tensor):
    """``shade(rgb, valid, flat, ijk) -> rgb``: the in-kernel lighting
    variant's Blinn-Phong (pallas_march.py:503-556, 594-620) in its float
    order: the normal ``0.5 (v[+1] - v[-1])`` per axis on the raw volume (0
    past a face, 0 off the volume), ``w = clip(|n| 1e3, 0, 1)``, the half
    vector ``l - d`` of each ray's direction ``d`` scaled by ``1 / max(|h|,
    1e-8)``, the specular ``|n.h| ** shininess``.  Lengths are square roots
    taken in float64 and rounded once, the correctly rounded ``sqrtf`` of
    the kernel."""
    dev = a.vol.device
    vflat = a.vol.reshape(-1)
    last = vflat.numel() - 1
    zero = torch.zeros((), dtype=_f32, device=dev)
    one = zero + 1.0
    tiny = torch.tensor(1e-8, dtype=_f32, device=dev)
    lv = a.lvec
    lx, ly, lz = lv[0], lv[1], lv[2]
    lc = lv[3:6]
    amb, dif, spe, shin = lv[6], lv[7], lv[8], lv[9]
    d1, d2, d3 = a.dims
    strides = (d2 * d3, d3, 1)

    def length(x, y, z):
        return torch.sqrt((((x * x + y * y) + z * z)).double()).to(_f32)

    hx, hy, hz = lx - d[..., 0], ly - d[..., 1], lz - d[..., 2]
    hinv = one / torch.maximum(length(hx, hy, hz), tiny)

    def shade(rgb, valid, flat, ijk):
        grad = []
        for c in range(3):
            def nb(step):
                nbr = ijk[..., c] + step
                ok = valid & (nbr >= 0) & (nbr < a.dims[c])
                v = vflat[(flat + step * strides[c]).clamp(0, last)]
                return torch.where(ok, v, zero)
            grad.append(0.5 * (nb(1) - nb(-1)))
        gx, gy, gz = grad
        nn = length(gx, gy, gz)
        ninv = one / torch.maximum(nn, tiny)
        nx, ny, nz = gx * ninv, gy * ninv, gz * ninv
        ndotl = ((nx * lx + ny * ly) + nz * lz).abs()
        ndoth = (((nx * hx + ny * hy) + nz * hz) * hinv).abs()
        spec = spe * torch.pow(ndoth, shin)
        w = (nn * np.float32(1e3)).clamp(0.0, 1.0)[..., None]
        lit = ((amb * rgb + ((dif * ndotl)[..., None] * rgb) * lc)
               + spec[..., None] * lc)
        return w * lit + (1.0 - w) * rgb

    return shade


def march_plain(a: MarchArgs, stats: dict | None = None):
    """Plain PyTorch version of the kernel -> [W, H, 4], or with
    ``a.segment`` the (C [W, H, 3], T [W, H, 1]) pair: the same function
    with the same float order, as a loop over samples vectorised over rays,
    in every variant (interval ids or LUT indices; baked light, in-kernel
    light or none; a 4-D volume's channel grids; a work unit's columns,
    samples and x-slab).  It marches every sample (the kernel's skips are
    exact) and stops each ray where the kernel does; on a slab a sample
    that another slab owns leaves (C, T) as it is.

    With ``stats``, ``stats["samples"]`` is set to the number of samples
    this input needs: those inside the dataset on rays not yet terminated.
    """
    dev = a.ids.device
    s = a.scal
    w, h = a.width, a.height
    o, d = _rays(a, a.x_offset, a.full_width)
    ids_at = _sample_ids(a, o, d)
    colors = _effective_colors(a)
    eps = s[S_EPS].clamp_min(0.0)
    one = torch.ones((), dtype=_f32, device=dev)
    zero = torch.zeros((), dtype=_f32, device=dev)
    baked = a.mgrid is not None
    if baked:
        mflat, sflat = a.mgrid.reshape(-1), a.sgrid.reshape(-1)
    if a.chans is not None:
        cflat = a.chans.reshape(a.chans.shape[0], -1)
    shade = _lit_shade(a, d) if a.vol is not None else None

    c = torch.zeros((w, h, 3), dtype=_f32, device=dev)
    t = torch.ones((w, h, 1), dtype=_f32, device=dev)
    needed = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(a.s_start, a.s_start + a.spr):
        active = t.abs() > eps
        mid, valid, flat, ijk = ids_at(i)
        if a.slab_x:
            active = active & owned_by(a, ijk)[..., None]
        rgba = colors[mid]
        alpha = rgba[..., 3:4]
        rgb = rgba[..., :3]
        if baked:  # rgb * M + S; off the volume M = 1, S = 0
            m = torch.where(valid, mflat[flat], one)[..., None]
            sh = torch.where(valid, sflat[flat], zero)[..., None]
            rgb = rgb * m + sh
        elif shade is not None:
            rgb = shade(rgb, valid, flat, ijk)
        elif a.chans is not None:  # rgb from the channels; 0 off the volume
            rgb = torch.where(valid[..., None], cflat[:, flat].movedim(0, -1),
                              zero).expand(w, h, 3)
        wgt = t * alpha
        c = torch.where(active, c + wgt * rgb, c)
        if stats is not None:
            needed += (valid & active[..., 0]).sum()
        t = torch.where(active, t * (1.0 - alpha), t)
    if stats is not None:
        stats["samples"] = int(needed)
    if a.segment:
        return c, t
    rgb = c + t * s[S_BG:S_BG + 3]
    return torch.cat([rgb, torch.ones((w, h, 1), dtype=_f32, device=dev)],
                     dim=-1)


def variant(a: MarchArgs) -> str:
    """The kernel variant that ``a`` launches: plain, lut, baked,
    lut_baked, lit, lut_lit or mc."""
    lut = a.ids.dtype == torch.uint16
    if a.chans is not None:
        return "mc"
    if a.vol is not None:
        return "lut_lit" if lut else "lit"
    if a.mgrid is None:
        return "lut" if lut else "plain"
    return "lut_baked" if lut else "baked"


def index32(a: MarchArgs) -> bool:
    """Whether the kernel takes 32-bit voxel indices for march input ``a``
    (``vrp_march_a1_index32`` in csrc/march.cu): where every flat index it
    forms stays below 2^31, that is where the largest grid it reads times
    its channels (the ids and baked (M, S): the slab's or the volume's
    planes; the channel grids; the in-kernel light's volume), plus one
    plane and one row (a voxel index one past a face, a neighbour's step),
    is below 2^31.  Else 64-bit."""
    d1, d2, d3 = a.dims
    channels = 1 if a.chans is None else a.chans.shape[0]
    elems = (a.slab_x or d1) * d2 * d3 * channels
    if a.vol is not None:
        elems = max(elems, d1 * d2 * d3)
    return elems + d2 * d3 + d3 < 2**31


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("march")
    fn = lib.vrp_march_a1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, id_bytes, occ, nbx, nby, nbz, d1, d2, d3,
        # depth, width, height, spr, conic, density_scale, mgrid, sgrid,
        # vol, lvec, chans, n_chans, x_offset, full_width, s_start, x0,
        # slab_x, segment, out, stream
        fn.argtypes = ([p, p, i, p, i, p] + [i] * 11
                       + [ctypes.c_float, p, p, p, p, p] + [i] * 7
                       + [p, p])
        fn.restype = ctypes.c_int
    return lib


def march_kernel(a: MarchArgs):
    """Launch ``csrc/march.cu`` on the current stream -> [W, H, 4], or with
    ``a.segment`` the (C [W, H, 3], T [W, H, 1]) pair; the variant follows
    the args (:func:`variant`): uint8 interval ids or uint16 LUT indices,
    with baked (M, S) grids, with the volume and light of in-kernel
    lighting, with a 4-D volume's channel grids, or plain; over a work
    unit's columns, samples and x-slab."""
    global launches
    dev = a.ids.device
    if dev.type != "cuda":
        raise ValueError(f"march_kernel needs CUDA tensors, got {dev}")
    if a.ids.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"ids: need uint8 or uint16, got {a.ids.dtype}")
    baked, lit, mc = (a.mgrid is not None, a.vol is not None,
                      a.chans is not None)
    if baked != (a.sgrid is not None) or lit != (a.lvec is not None):
        raise ValueError("mgrid and sgrid go together, and vol and lvec")
    if baked + lit + mc > 1 or (mc and a.ids.dtype != torch.uint8):
        raise ValueError("one of baked light, in-kernel light or channel "
                         "grids (the last with interval ids)")
    if a.slab_x and (lit or (baked and a.ids.dtype != torch.uint8)):
        raise ValueError("an x-slab takes no in-kernel light, and baked "
                         "(M, S) with interval ids")
    grid = (a.slab_x or a.dims[0],) + tuple(a.dims[1:])
    checks = [("scal", a.scal, _f32, (SCAL_LEN,)),
              ("colors", a.colors, _f32, None),
              ("ids", a.ids, a.ids.dtype, grid),
              ("occ", a.occ, torch.int32, None)]
    if baked:
        checks += [("mgrid", a.mgrid, _f32, grid),
                   ("sgrid", a.sgrid, _f32, grid)]
    if lit:
        checks += [("vol", a.vol, _f32, a.dims), ("lvec", a.lvec, _f32, (10,))]
    if mc:
        checks.append(("chans", a.chans, _f32, (a.chans.shape[0],) + grid))
        if a.chans.shape[0] not in (1, 3):
            raise ValueError("chans: need 1 or 3 channel grids")
    for name, t, dtype, shape in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    id_bytes = a.ids.element_size()
    max_k = MAX_INTERVALS if id_bytes == 1 else MAX_LUT
    k = a.colors.shape[0]
    if not 0 < k <= max_k or a.colors.shape[1] != 4:
        raise ValueError(f"colors must be [K <= {max_k}, 4]")
    lib = _kernel_lib()
    out = torch.empty((a.width, a.height, 4), dtype=_f32, device=dev)
    nbx, nby, nbz = a.nbricks

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.vrp_march_a1(
            a.scal.data_ptr(), a.colors.data_ptr(), k, a.ids.data_ptr(),
            id_bytes, a.occ.data_ptr(), nbx, nby, nbz, *a.dims, a.depth,
            a.width, a.height, a.spr, int(a.conic), a.density_scale,
            ptr(a.mgrid), ptr(a.sgrid), ptr(a.vol), ptr(a.lvec),
            ptr(a.chans), a.chans.shape[0] if mc else 0, a.x_offset,
            a.full_width or a.width, a.s_start, a.x0, a.slab_x,
            int(a.segment), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant(a)] += 1
    if a.segment:
        shard_launches["slab" if a.slab_x else "segment"] += 1
        return out[..., :3], out[..., 3:]
    return out


def render_vrc_fused(volume, tf, camera, config: RenderConfig,
                     early_eps: float | None = None,
                     light: Light | None = None, **unit):
    """a1/VRC render through the fused march -> [W, H, 4] (alpha 1), or a
    sharded render's work unit (pallas_march.py:1837) with ``unit``, the
    keywords of :func:`prepare`: with ``segment=True`` the (C [w, H, 3],
    T [w, H, 1]) pair of its columns, samples and x-slab, whose early
    termination acts on the unit's own T, which starts at 1.

    CUDA tensors launch the kernel; CPU tensors run :func:`march_plain`.
    ``early_eps`` defaults to ``config.early_termination``.
    """
    eps = config.early_termination if early_eps is None else early_eps
    a = prepare(volume, tf, camera, config, eps, light, **unit)
    if a.ids.is_cuda:
        return march_kernel(a)
    return march_plain(a)
