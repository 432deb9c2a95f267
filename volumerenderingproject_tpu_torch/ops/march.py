"""The fused a1/VRC ray march: its prep, its plain PyTorch version and the
wrapper of its CUDA kernel (``csrc/march.cu``).

Counterpart of ``volumerenderingproject_tpu/ops/pallas_march.py`` in resident
mode: ortho or conic rays, nearest-voxel sampling, classification by the
interval scan or a dense LUT (``config.tf_lut``), baked Blinn-Phong shading
(``config.lighting``, ortho), ``density_scale``, front-to-back (C, T)
compositing and early ray termination.

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
  * ``ops/phong.bake_light_grids``: with lighting, the per-voxel factors
    (M, S) such that a sample's shaded colour is ``rgb * M + S``
    (pallas_march.py:1225-1270).  The view direction ``-camera.front`` is
    the same for every ortho ray, so every input of the shading is a
    per-voxel quantity; the bake is rebuilt for every frame;
  * :func:`scal_vector`: camera, screen, box and TF scalars for the kernel.

Every skip the kernel makes is exact: a skipped sample has alpha exactly 0
and leaves (C, T) unchanged.  A negative alpha (a fit can drive one below
0) changes T, so it counts as occupied.  When TF(0).alpha != 0 (samples off
the volume change the image) or ``config.empty_space_skipping`` is off, the
kernel marches every sample.  Early termination stops a ray before the
first sample at which T <= eps, which changes the output by at most eps
times the largest colour; :func:`march_plain` stops at the same sample.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import transforms as T
from ..utils.config import Algorithm, Interp, RenderConfig
from . import _build
from .phong import (Light, bake_light_grids, check_uniform_light,
                    default_light, is_lit)

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
variant_launches = {"plain": 0, "lut": 0, "baked": 0, "lut_baked": 0}


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
    mgrid: Optional[torch.Tensor] = None  # [X, Y, Z] f32 baked M, lit only
    sgrid: Optional[torch.Tensor] = None  # [X, Y, Z] f32 baked S, lit only


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


def _box(dims, depth):
    """Dataset box in ray space (p = pos + 0.5 in [hg/L, (hg+dim)/L + 1/n]),
    intersected with the root cube, conservative by half a voxel
    (pallas_march.py:1709-1716)."""
    L = float(max(dims))
    n = float(2**depth)
    lo = [max(0.0, (L / 2 - d / 2) / L) - 0.5 for d in dims]
    hi = [min(1.0, (L / 2 + d / 2) / L + 1.0 / n) - 0.5 for d in dims]
    return lo, hi


def scal_vector(camera, config: RenderConfig, dims, depth, cal_max_trunc,
                early_eps: float, full_march: torch.Tensor,
                id0: torch.Tensor) -> torch.Tensor:
    """The kernel's [32] f32 scalar vector (slots ``S_*`` above), built on
    the camera's device without a round trip to the host."""
    dev = camera.device
    top_left = camera.top_left
    if config.conic and config.conic_corrected:
        top_left = top_left + torch.tensor(
            config.viewplane_distance, dtype=_f32, device=dev) * camera.front
    box_lo, box_hi = _box(dims, depth)

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


def check_supported(config: RenderConfig, channels: int) -> None:
    """Raise NotImplementedError, naming the ROADMAP.md item (queue 1), for
    what the port's a1 path does not render yet: the plain scan computes
    single-channel a1 with nearest-voxel sampling, lit or not, through the
    interval scan or a LUT.  (a5 has its own check,
    ``ops/a5.check_supported``; the fused march adds
    :func:`check_fused_supported`.)"""
    if config.algorithm is Algorithm.POINT:
        raise NotImplementedError(
            "Algorithm.POINT is not ported yet: ROADMAP.md item 15 "
            "(point_splat)")
    if config.scattering:
        raise NotImplementedError(
            "scattering is not ported yet: ROADMAP.md item 9 (lighting, LUT "
            "and scattering: henyey_greenstein, light_transmittance_grid, "
            "bake_scatter_grid)")
    if config.interp is Interp.TRILINEAR:
        raise NotImplementedError(
            "Interp.TRILINEAR is not ported yet: ROADMAP.md item 12 "
            "(smooth mode)")
    if config.interp is Interp.TRILINEAR_COLOR:
        raise NotImplementedError(
            "Interp.TRILINEAR_COLOR is not ported yet: ROADMAP.md item 8 "
            "(a5 sampling)")
    if channels != 1:
        raise NotImplementedError(
            "multichannel volumes are not ported yet: ROADMAP.md item 10 "
            "(multichannel)")


def check_fused_supported(config: RenderConfig, light: Light | None) -> None:
    """What the fused march adds to :func:`check_supported`: lighting only
    through the bake, which needs ortho rays and a uniform light colour
    (NotImplementedError, naming the ROADMAP.md item).  (A LUT of more than
    1024 entries raises in :func:`lut_ids`.)"""
    if not is_lit(config, light):
        return
    if config.conic:
        raise NotImplementedError(
            "conic lighting in the fused march is not ported yet: ROADMAP.md "
            "item 9 (K1's in-kernel lighting variant); mode='scan' renders "
            "it")
    check_uniform_light(light)


def prepare(volume, tf, camera, config: RenderConfig, early_eps: float,
            light: Light | None = None) -> MarchArgs:
    """Prep for one march; all tensors on the volume's device.  ``light``
    defaults to :func:`ops.phong.default_light` where the render is lit."""
    check_supported(config, volume.channels)
    check_fused_supported(config, light)
    dev = volume.data.device
    tf = tf.to(dev)
    camera = camera.to(dev)
    cal_max_trunc = torch.trunc(volume.cal_max.to(_f32))
    if config.tf_lut:
        table = tf.to_lut(config.tf_lut)
        ids = lut_ids(volume.data, config.tf_lut, cal_max_trunc)
        id0 = torch.zeros((), dtype=torch.int64, device=dev)
    else:
        table = tf.colors
        ids, id0 = material_ids(volume.data, tf, cal_max_trunc)
    occ, nb = brick_occupancy(ids, table)
    alpha0 = table[id0, 3]
    if config.density_scale != 1.0:
        alpha0 = (alpha0 * np.float32(config.density_scale)).clamp(0.0, 1.0)
    full = alpha0 != 0.0
    if not config.empty_space_skipping:
        full = torch.ones_like(full)
    scal = scal_vector(camera, config, volume.dims, volume.octree_depth,
                       cal_max_trunc, early_eps, full, id0)
    mgrid = sgrid = None
    if is_lit(config, light):
        lg = default_light(dev) if light is None else light.to(dev)
        mgrid, sgrid = bake_light_grids(volume.data, config, lg,
                                        -camera.front)
    return MarchArgs(
        scal=scal, colors=table.to(_f32).contiguous(), ids=ids, occ=occ,
        nbricks=nb, dims=volume.dims, depth=volume.octree_depth,
        width=config.width, height=config.height,
        spr=config.samples_per_ray, conic=bool(config.conic),
        density_scale=float(config.density_scale), mgrid=mgrid, sgrid=sgrid)


def _effective_colors(a: MarchArgs) -> torch.Tensor:
    colors = a.colors
    if a.density_scale != 1.0:
        alpha = (colors[:, 3:4] * np.float32(a.density_scale)).clamp(0.0, 1.0)
        colors = torch.cat([colors[:, :3], alpha], dim=1)
    return colors


def _rays(a: MarchArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions [W, H, 3] of the kernel's rays (its ray
    setup, expression by expression)."""
    dev = a.ids.device
    s = a.scal
    w, h = a.width, a.height
    x = torch.arange(w, dtype=_f32, device=dev)[:, None].expand(w, h)
    y = torch.arange(h, dtype=_f32, device=dev)[None, :].expand(w, h)
    # divide by device tensors: CUDA divides by a host scalar as a product
    # with its reciprocal, which is not the IEEE quotient the kernel takes
    size = torch.tensor([w, h], dtype=_f32, device=dev)
    xs = ((x * s[S_RSW]) / size[0])[..., None]
    ys = ((y * s[S_RSH]) / size[1])[..., None]
    xt = xs * s[S_RIGHT:S_RIGHT + 3]
    yt = ys * (-s[S_UP:S_UP + 3])
    if a.conic:
        o = s[S_POS:S_POS + 3].expand(w, h, 3)
        rd = ((s[S_TL:S_TL + 3] + xt) + yt) - s[S_POS:S_POS + 3]
        return o, T.normalize(rd)
    return (s[S_TL:S_TL + 3] + xt) + yt, s[S_FRONT:S_FRONT + 3].expand(w, h, 3)


def _sample_ids(a: MarchArgs, o: torch.Tensor, d: torch.Tensor):
    """``ids_at(i) -> (id int64 [W, H], valid bool [W, H], flat int64
    [W, H])``: the colour id of every ray's sample i by the kernel's index
    chain (modelAux +0.5, octree nearest voxel), whether it lies in the
    volume, and its voxel's flat index (clamped into range); samples off
    the volume take ``id0``."""
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

    def ids_at(i: int):
        ti = torch.tensor(float(i), dtype=_f32, device=dev) * s[S_DS] + s[S_CLIP]
        p = (o + ti * d) + 0.5
        res = (torch.floor(p * n) / n) * L
        valid = (((p >= 0.0) & (p < 1.0) & (res >= hg) & (res < hg_hi))
                 .all(dim=-1))
        ijk = torch.trunc((res + halfd) - halfL).to(torch.int64)
        flat = (ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3
                + ijk[..., 2]).clamp(0, d1 * d2 * d3 - 1)
        return torch.where(valid, ids_flat[flat], id0), valid, flat

    return ids_at


def march_plain(a: MarchArgs, stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel -> [W, H, 4]: the same function
    with the same float order, as a loop over samples vectorised over rays,
    in every variant (interval ids or LUT indices, baked light or not).  It
    marches every sample (the kernel's skips are exact) and stops each ray
    where the kernel does.

    With ``stats``, ``stats["samples"]`` is set to the number of samples
    this input needs: those inside the dataset on rays not yet terminated.
    """
    dev = a.ids.device
    s = a.scal
    w, h = a.width, a.height
    o, d = _rays(a)
    ids_at = _sample_ids(a, o, d)
    colors = _effective_colors(a)
    eps = s[S_EPS].clamp_min(0.0)
    baked = a.mgrid is not None
    if baked:
        mflat, sflat = a.mgrid.reshape(-1), a.sgrid.reshape(-1)
        one = torch.ones((), dtype=_f32, device=dev)
        zero = torch.zeros((), dtype=_f32, device=dev)

    c = torch.zeros((w, h, 3), dtype=_f32, device=dev)
    t = torch.ones((w, h, 1), dtype=_f32, device=dev)
    needed = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(a.spr):
        active = t > eps
        mid, valid, flat = ids_at(i)
        rgba = colors[mid]
        alpha = rgba[..., 3:4]
        rgb = rgba[..., :3]
        if baked:  # rgb * M + S; off the volume M = 1, S = 0
            m = torch.where(valid, mflat[flat], one)[..., None]
            sh = torch.where(valid, sflat[flat], zero)[..., None]
            rgb = rgb * m + sh
        wgt = t * alpha
        c = torch.where(active, c + wgt * rgb, c)
        if stats is not None:
            needed += (valid & active[..., 0]).sum()
        t = torch.where(active, t * (1.0 - alpha), t)
    if stats is not None:
        stats["samples"] = int(needed)
    rgb = c + t * s[S_BG:S_BG + 3]
    return torch.cat([rgb, torch.ones((w, h, 1), dtype=_f32, device=dev)],
                     dim=-1)


def variant(a: MarchArgs) -> str:
    """The kernel variant that ``a`` launches: plain, lut, baked or
    lut_baked."""
    lut = a.ids.dtype == torch.uint16
    if a.mgrid is None:
        return "lut" if lut else "plain"
    return "lut_baked" if lut else "baked"


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load("march")
    fn = lib.vrp_march_a1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # scal, colors, K, ids, id_bytes, occ, nbx, nby, nbz, d1, d2, d3,
        # depth, width, height, spr, conic, density_scale, mgrid, sgrid,
        # out, stream
        fn.argtypes = ([p, p, i, p, i, p] + [i] * 11
                       + [ctypes.c_float, p, p, p, p])
        fn.restype = ctypes.c_int
    return lib


def march_kernel(a: MarchArgs) -> torch.Tensor:
    """Launch ``csrc/march.cu`` on the current stream -> [W, H, 4]; the
    variant follows the args: uint8 interval ids or uint16 LUT indices,
    with baked (M, S) grids or without."""
    global launches
    dev = a.ids.device
    if dev.type != "cuda":
        raise ValueError(f"march_kernel needs CUDA tensors, got {dev}")
    if a.ids.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"ids: need uint8 or uint16, got {a.ids.dtype}")
    baked = a.mgrid is not None
    if baked != (a.sgrid is not None):
        raise ValueError("mgrid and sgrid go together")
    checks = [("scal", a.scal, _f32), ("colors", a.colors, _f32),
              ("ids", a.ids, a.ids.dtype), ("occ", a.occ, torch.int32)]
    if baked:
        checks += [("mgrid", a.mgrid, _f32), ("sgrid", a.sgrid, _f32)]
    for name, t, dtype in checks:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if a.scal.numel() != SCAL_LEN or a.ids.shape != a.dims or (
            baked and (a.mgrid.shape != a.dims or a.sgrid.shape != a.dims)):
        raise ValueError("scal, ids or the light grids do not match the "
                         "march geometry")
    id_bytes = a.ids.element_size()
    max_k = MAX_INTERVALS if id_bytes == 1 else MAX_LUT
    k = a.colors.shape[0]
    if not 0 < k <= max_k or a.colors.shape[1] != 4:
        raise ValueError(f"colors must be [K <= {max_k}, 4]")
    lib = _kernel_lib()
    out = torch.empty((a.width, a.height, 4), dtype=_f32, device=dev)
    nbx, nby, nbz = a.nbricks
    with torch.cuda.device(dev):
        err = lib.vrp_march_a1(
            a.scal.data_ptr(), a.colors.data_ptr(), k, a.ids.data_ptr(),
            id_bytes, a.occ.data_ptr(), nbx, nby, nbz, *a.dims, a.depth,
            a.width, a.height, a.spr, int(a.conic), a.density_scale,
            a.mgrid.data_ptr() if baked else None,
            a.sgrid.data_ptr() if baked else None, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {err}")
    launches += 1
    variant_launches[variant(a)] += 1
    return out


def render_vrc_fused(volume, tf, camera, config: RenderConfig,
                     early_eps: float | None = None,
                     light: Light | None = None) -> torch.Tensor:
    """a1/VRC render through the fused march -> [W, H, 4] (alpha 1).

    CUDA tensors launch the kernel; CPU tensors run :func:`march_plain`.
    ``early_eps`` defaults to ``config.early_termination``.
    """
    eps = config.early_termination if early_eps is None else early_eps
    a = prepare(volume, tf, camera, config, eps, light)
    if a.ids.is_cuda:
        return march_kernel(a)
    return march_plain(a)
