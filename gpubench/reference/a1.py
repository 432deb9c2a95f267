"""Plain PyTorch reference of the a1/VRC frame of the reference app
(RodrigoGomesSantos/VolumeRenderingProject), which the benchmark holds the
program's frames and fits against.

It imports nothing but torch and numpy, and takes only the inputs that the
benchmark makes: the voxel intensities, the transfer function's intervals
and colours, the light, the camera's five vectors.  Per sample, as the
reference app's kernels compute it (kernel.cu:20-70, Octree.cu:85-100,
158-183): the ray's origin on the orthographic screen, the sample's world
position, modelAux's +0.5, the octree's nearest voxel of the centered
dataset, the intensity over trunc(cal_max), the interval that matches it
last (interval 0 where none does), optionally Blinn-Phong on the voxel's
Sobel gradient, and front-to-back compositing over the background.  The
position chain is written in the app's float order, one float32 operation
at a time, so that a sample lands in the voxel the app's expression gives.
A ray stops before its first sample at which |T| <= eps (the render's early
termination); eps 0 marches every sample.

Departures from the app: the light's colour enters through its channel
mean (a grey light, as the fused light fit defines it); the Phong terms are
this repository's lighting extension (the app's shading is a stub).  A frame
is the scan a sample at a time over every ray, in the app's order; a fit's
loss, for autograd, takes the same sums as cumulative products and sums
along the ray at eps 0, in blocks of image columns, which round in another
order.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

F32 = torch.float32
GRAD_THRESHOLD = 1e-3  # gradient length below which shading fades out
SAMPLES_PER_BLOCK = 6_000_000  # ray samples held at once


class View(NamedTuple):
    """One orthographic camera: position, front, right, up and the
    screen's top-left corner, float32 [3] each."""

    position: torch.Tensor
    front: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    top_left: torch.Tensor


class Frame(NamedTuple):
    """The render settings the reference reads (float32 where the app's
    are float)."""

    width: int
    height: int
    spr: int
    ds: float  # (viewplane - front_clip) / spr
    clip: float
    rsw: float  # 2 tan(view_angle)
    rsh: float  # rsw * height / width
    background: tuple
    lighting: bool

    @staticmethod
    def of(render: dict) -> "Frame":
        w, h, spr = render["width"], render["height"], render["samples_per_ray"]
        clip = float(render.get("front_clip", 0.0))
        vp = float(render.get("viewplane_distance", 2.0))
        rsw = 2.0 * math.tan(float(render.get("view_angle", math.pi / 4)))
        lit = bool(render.get("lighting", False))
        if (render.get("conic") or float(render.get("presmooth_sigma", 0.0))
                or (lit and render.get("gradient_filter") != "sobel")):
            raise ValueError("the reference renders orthographic rays, lit "
                             "through the Sobel filter without presmoothing")
        return Frame(w, h, spr, (vp - clip) / spr, clip, rsw, rsw * h / w,
                     tuple(render.get("background", (0.2, 0.2, 0.2, 1.0)))[:3],
                     lit)


class Light(NamedTuple):
    """direction [3], color [3], ambient, diffuse, specular, shininess."""

    direction: torch.Tensor
    color: torch.Tensor
    ambient: torch.Tensor
    diffuse: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor


def _f32(v, dev) -> torch.Tensor:
    return torch.tensor(v, dtype=F32, device=dev)


def octree_depth(dims) -> int:
    """Smallest d with 2**d >= the longest dimension (Octree.cu:40-41)."""
    d = 0
    while 2 ** d < max(dims):
        d += 1
    return d


def ray_origins(view: View, fr: Frame, x0: int, x1: int) -> torch.Tensor:
    """Origins [x1 - x0, H, 3] of the rays of image columns [x0, x1):
    (top_left + ((x rsw) / W) right) + ((y rsh) / H) (-up)
    (kernel.cu:20-38, 54-58)."""
    dev = view.position.device
    x = torch.arange(x0, x1, dtype=F32, device=dev)[:, None].expand(
        x1 - x0, fr.height)
    y = torch.arange(fr.height, dtype=F32, device=dev)[None, :].expand(
        x1 - x0, fr.height)
    size = _f32([fr.width, fr.height], dev)
    xs = ((x * _f32(fr.rsw, dev)) / size[0])[..., None]
    ys = ((y * _f32(fr.rsh, dev)) / size[1])[..., None]
    return (view.top_left + xs * view.right) + ys * (-view.up)


def voxel_of(p: torch.Tensor, dims):
    """(flat voxel index int64 [...], inside bool [...]) of positions ``p``
    [..., 3] after modelAux's +0.5: the octree's cell k = floor(p 2^d),
    res = (k / 2^d) L, inside the root cube and the centered dataset, voxel
    trunc((res + dim / 2) - L / 2) (Octree.cu:85-100); the index is
    clamped into the grid where the sample lies outside."""
    dev = p.device
    d1, d2, d3 = dims
    L = np.float32(max(dims))
    n = np.float32(2 ** octree_depth(dims))
    res = (torch.floor(p * n) / n) * L
    lo = _f32([np.float32(L / 2) - np.float32(v / 2) for v in dims], dev)
    hi = lo + _f32([float(v) for v in dims], dev)
    inside = ((p >= 0.0) & (p < 1.0) & (res >= lo) & (res < hi)).all(-1)
    half = _f32([np.float32(v / 2) for v in dims], dev)
    ijk = torch.trunc((res + half) - np.float32(L / 2)).to(torch.int64)
    flat = (ijk[..., 0] * (d2 * d3) + ijk[..., 1] * d3 + ijk[..., 2])
    return flat.clamp(0, d1 * d2 * d3 - 1), inside


def sample_times(fr: Frame, dev) -> torch.Tensor:
    """i ds + clip [S] for every sample index i (kernel.cu:54, 59)."""
    return (torch.arange(fr.spr, dtype=F32, device=dev) * _f32(fr.ds, dev)
            + _f32(fr.clip, dev))


def sample_voxels(view: View, fr: Frame, dims, x0: int, x1: int):
    """:func:`voxel_of` [x1 - x0, H, S] of every sample of the rays of
    columns [x0, x1): position (o + (i ds + clip) front) + 0.5."""
    o = ray_origins(view, fr, x0, x1)
    ti = sample_times(fr, o.device)
    p = (o[:, :, None, :] + ti[:, None] * view.front) + 0.5
    return voxel_of(p, dims)


def classify(v_norm: torch.Tensor, lower: torch.Tensor,
             upper: torch.Tensor) -> torch.Tensor:
    """The interval of each normalised intensity: the last whose inclusive
    bounds hold it, interval 0 where none does
    (TransferFunction.cu:46-55)."""
    cls = torch.zeros(v_norm.shape, dtype=torch.uint8, device=v_norm.device)
    for k in range(1, lower.shape[0]):
        cls.masked_fill_((v_norm >= lower[k]) & (v_norm <= upper[k]), k)
    return cls


def sample_classes(data: torch.Tensor, cal_max: float, lower, upper,
                   flat: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """Each sample's interval: its voxel's max(v, 0) / trunc(cal_max), 0
    outside the dataset (kernel.cu:42, 64-66)."""
    v = data.reshape(-1)[flat].clamp_min(0.0)
    v = torch.where(inside, v, torch.zeros((), dtype=F32, device=v.device))
    return classify(v / _f32(math.trunc(cal_max), v.device), lower, upper)


def _corr1d(v: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Zero-padded 3-tap cross-correlation along ``axis``, the taps added
    in order."""
    n = v.shape[axis]
    pad = [0, 0] * 3
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = 1
    vp = torch.nn.functional.pad(v, pad)
    out = None
    for j, k in enumerate(taps):
        term = vp.narrow(axis, j, n) * k
        out = term if out is None else out + term
    return out


def sobel_gradient(data: torch.Tensor) -> torch.Tensor:
    """Sobel gradient [X, Y, Z, 3]: along each axis the difference taps
    (-1/2, 0, 1/2) and along the other two the smoothing taps (1/4, 1/2,
    1/4), applied in axis order, zero past the faces."""
    grads = []
    for axis in range(3):
        out = data.to(F32)
        for ax2 in range(3):
            taps = (-0.5, 0.0, 0.5) if ax2 == axis else (0.25, 0.5, 0.25)
            out = _corr1d(out, taps, ax2)
        grads.append(out)
    return torch.stack(grads, dim=-1)


def shade_table(data: torch.Tensor) -> torch.Tensor:
    """[X*Y*Z + 1, 4]: each voxel's unit Sobel normal and its shading
    weight clip(|g| / GRAD_THRESHOLD, 0, 1); the last row, which samples
    outside the dataset read, has weight 0 (unshaded)."""
    g = sobel_gradient(data).reshape(-1, 3)
    norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
    n = g / norm.clamp_min(1e-8)
    w = (norm / GRAD_THRESHOLD).clamp(0.0, 1.0)
    table = torch.cat([n, w], dim=-1)
    return torch.cat([table, torch.zeros_like(table[:1])])


def phong(rgb: torch.Tensor, nw: torch.Tensor, light: Light,
          front: torch.Tensor) -> torch.Tensor:
    """Blinn-Phong of colours [..., 3] at samples whose unit normal and
    weight are ``nw`` [..., 4], viewed along -front under a grey light of
    the colour's mean: w (ambient rgb + diffuse |n.l| c rgb + specular
    |n.h|^shininess c) + (1 - w) rgb."""
    dtype = rgb.dtype
    l = light.direction / torch.linalg.vector_norm(light.direction)
    v = -front / torch.linalg.vector_norm(front)
    h = l + v
    h = h / torch.linalg.vector_norm(h).clamp_min(1e-8)
    n, w = nw[..., :3].to(dtype), nw[..., 3:4].to(dtype)
    ndotl = (n * l.to(dtype)).sum(-1, keepdim=True).abs()
    ndoth = (n * h.to(dtype)).sum(-1, keepdim=True).abs()
    base = ndoth.clamp_min(1e-6)
    pw = torch.where(ndoth > 0, base ** light.shininess.to(dtype),
                     torch.zeros((), dtype=dtype, device=rgb.device))
    c = light.color.mean().to(dtype)
    spec = light.specular.to(dtype) * pw
    shaded = (light.ambient.to(dtype) * rgb
              + light.diffuse.to(dtype) * ndotl * rgb * c + spec * c)
    return w * shaded + (1.0 - w) * rgb


def composite(rgb: torch.Tensor, alpha: torch.Tensor):
    """Front to back along the last sample axis, every sample: (C [..., 3],
    T_N [...]) with T_i = prod_{j < i} (1 - a_j), C = sum_i T_i a_i rgb_i."""
    t_incl = torch.cumprod(1.0 - alpha, dim=-1)
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]),
                        t_incl[..., :-1]], dim=-1)
    c = ((t_excl * alpha)[..., None] * rgb).sum(dim=-2)
    return c, t_incl[..., -1]


class Scene(NamedTuple):
    """What a render reads: intensities [X, Y, Z] f32, cal_max, the TF's
    bounds [K] f32, the lighting's shade table (None unlit)."""

    data: torch.Tensor
    cal_max: float
    lower: torch.Tensor
    upper: torch.Tensor
    table: Optional[torch.Tensor]

    @staticmethod
    def of(data, cal_max, lower, upper, lighting: bool) -> "Scene":
        return Scene(data, float(cal_max), lower, upper,
                     shade_table(data) if lighting else None)


def _blocks(fr: Frame):
    step = max(1, SAMPLES_PER_BLOCK // (fr.height * fr.spr))
    for x0 in range(0, fr.width, step):
        yield x0, min(fr.width, x0 + step)


def take_colors(colors: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """``colors[cls]`` [..., 4] as a sum over the intervals of each one's
    colour where the sample is of it (exact: one term is not 0).  Its
    gradient is a sum a interval; indexing's own backward accumulates the
    millions of samples of a few intervals one after another on CUDA."""
    out = None
    for k in range(colors.shape[0]):
        term = torch.where((cls == k)[..., None], colors[k],
                           torch.zeros((), dtype=colors.dtype,
                                       device=colors.device))
        out = term if out is None else out + term
    return out


def _image_block(scene: Scene, fr: Frame, view: View, colors, density,
                 light, cls, vox, dtype):
    """One block's image rgb [bx, H, 3] at eps 0 from each sample's class
    ``cls`` and, lit, its shade-table row ``vox``."""
    rgba = take_colors(colors.to(dtype), cls)
    alpha = rgba[..., 3] * density.to(dtype)
    rgb = rgba[..., :3]
    if scene.table is not None:
        rgb = phong(rgb, scene.table[vox], light, view.front)
    c, t_n = composite(rgb, alpha)
    bg = torch.tensor(fr.background, dtype=dtype, device=c.device)
    return (c + t_n[..., None] * bg).to(F32)


def render(scene: Scene, fr: Frame, view: View, colors: torch.Tensor,
           light: Optional[Light], eps: float, dtype=F32):
    """-> (image [W, H, 3] f32, samples needed): the frame of ``colors``
    [K, 4] by the straightforward front-to-back scan, a sample at a time
    over every ray: w = T a, C += w rgb, T *= 1 - a while |T| > eps, then
    C + T background.  Colours, shading and compositing in ``dtype``,
    positions and voxels in float32; the samples needed are those inside
    the dataset on rays not yet stopped."""
    dev = scene.data.device
    w, h = fr.width, fr.height
    with torch.no_grad():
        o = ray_origins(view, fr, 0, w)
        ti = sample_times(fr, dev)
        table = colors.to(dtype)
        c = torch.zeros((w, h, 3), dtype=dtype, device=dev)
        t = torch.ones((w, h, 1), dtype=dtype, device=dev)
        needed = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(fr.spr):
            flat, inside = voxel_of((o + ti[i] * view.front) + 0.5,
                                    scene.data.shape)
            cls = sample_classes(scene.data, scene.cal_max, scene.lower,
                                 scene.upper, flat, inside)
            rgba = table[cls.long()]
            alpha, rgb = rgba[..., 3:4], rgba[..., :3]
            if scene.table is not None:
                vox = torch.where(inside, flat, scene.table.shape[0] - 1)
                rgb = phong(rgb, scene.table[vox], light, view.front)
            live = t.abs() > eps
            wgt = t * alpha
            c = torch.where(live, c + wgt * rgb, c)
            t = torch.where(live, t * (1.0 - alpha), t)
            needed += (inside & live[..., 0]).sum()
        bg = torch.tensor(fr.background, dtype=dtype, device=dev)
        return (c + t * bg).to(F32), int(needed)


class Samples(NamedTuple):
    """A view's samples, kept for a fit's steps: classes uint8 [W, H, S]
    and, lit, shade-table rows int32."""

    cls: torch.Tensor
    vox: Optional[torch.Tensor]


def view_samples(scene: Scene, fr: Frame, view: View) -> Samples:
    cls_all = torch.empty((fr.width, fr.height, fr.spr), dtype=torch.uint8,
                          device=scene.data.device)
    vox_all = (torch.empty(cls_all.shape, dtype=torch.int32,
                           device=cls_all.device)
               if scene.table is not None else None)
    with torch.no_grad():
        for x0, x1 in _blocks(fr):
            flat, inside = sample_voxels(view, fr, scene.data.shape, x0, x1)
            cls_all[x0:x1] = sample_classes(scene.data, scene.cal_max,
                                            scene.lower, scene.upper, flat,
                                            inside)
            if vox_all is not None:
                vox_all[x0:x1] = torch.where(inside, flat,
                                             scene.table.shape[0] - 1)
    return Samples(cls_all, vox_all)


def loss_and_grad(scene: Scene, fr: Frame, view: View, smp: Samples,
                  target: torch.Tensor, leaves: Dict[str, torch.Tensor],
                  dtype=F32):
    """The fit's loss, mean((image - target)^2) over rgb, and its gradient
    by autograd with respect to ``leaves`` (tf_colors [K, 4],
    density_scale, and for a light fit the light's six fields), the image
    of colours whose alpha is scaled by max(density_scale, 0), block by
    block -> (loss, {name: gradient})."""
    for t in leaves.values():
        t.grad = None
    light = (Light(*(leaves[k] for k in Light._fields))
             if "ambient" in leaves else None)
    if scene.table is not None and light is None:
        raise ValueError("a lit fit's reference needs the light's leaves, "
                         "or a fixed light among them")
    scale = 1.0 / (fr.width * fr.height * 3)
    total = 0.0
    for x0, x1 in _blocks(fr):
        # each block's graph is its own: backward frees what it saved
        density = torch.clamp_min(leaves["density_scale"], 0.0)
        vox = None if smp.vox is None else smp.vox[x0:x1].long()
        img = _image_block(scene, fr, view, leaves["tf_colors"], density,
                           light, smp.cls[x0:x1], vox, dtype)
        part = ((img - target[x0:x1, :, :3]) ** 2).sum() * scale
        part.backward()
        total += float(part.detach())
    return total, {k: t.grad.detach().clone() for k, t in leaves.items()}


def adam_fit(scene: Scene, fr: Frame, view: View, smp: Samples,
             target: torch.Tensor, start: Dict[str, torch.Tensor],
             steps: int, lr: float, dtype=F32):
    """Adam (b1 0.9, b2 0.999, eps 1e-8) from ``start`` for ``steps`` steps
    -> (losses [steps], leaves after the last step, each step's gradient
    [steps] of {name: gradient})."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    leaves = {k: v.detach().clone().requires_grad_() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses: List[float] = []
    grads: List[Dict[str, torch.Tensor]] = []
    for t in range(1, steps + 1):
        loss, g = loss_and_grad(scene, fr, view, smp, target, leaves, dtype)
        losses.append(loss)
        grads.append(g)
        with torch.no_grad():
            for k, p in leaves.items():
                m[k].mul_(b1).add_((1 - b1) * g[k])
                v2[k].mul_(b2).add_((1 - b2) * g[k] * g[k])
                mhat = m[k] / (1 - b1 ** t)
                vhat = v2[k] / (1 - b2 ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return losses, {k: v.detach() for k, v in leaves.items()}, grads
