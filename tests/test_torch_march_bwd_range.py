"""Each ray's sample spans in K4, the a1 backward march
(``ops/march_vjp.sample_range``, the mirror of ``bwd_spans`` in
csrc/march_bwd.cu on ``box_span`` in csrc/march_common.cuh, in their float
order).  K4 runs the full chain only on the samples of the chain's span (and,
on an x-slab, on those it may own but does not surely own); every other
sample it visits is owned and off the volume, the constant of id0, and it
skips the samples another slab owns.  That is exact only if

- no sample whose chain gives a voxel lies outside the chain's span;
- on a slab, no sample the slab owns lies outside the samples it visits,
  and every sample that is neither in the chain's span nor in the pad of
  the ownership span is owned;

these tests hold the spans to that on the scenes where they are easiest to
get wrong (odd dimensions, ortho and conic orbits, a camera inside the
volume, axis-parallel rays, rays that miss, a step longer than a voxel, a
512-deep volume, segment windows, the first, an interior and the last slab,
rays stepped an ulp at a time across each face of the box and the slabs'
planes), then check what the kernel builds on them: a backward march that
gives the constant samples their interval, alpha and g . c', sums their w,
T and the numerator of dL/da and folds the sums into interval k0 once a
ray (a run of them at once where TF(0).alpha is 0) stays within rtol 1e-5 of
``march_bwd_plain`` in every variant.  Off a slab the chain's span is
K1's own clip (march.cu: the same box_span of the same box), so the first
property holds K1 as well; without the pad the clip fails it on rays within
1e-7 of parallel to a face.

The kernel itself is held against the plain version on the card by
chip_smoke.py (phases 3b, 3j, 3k, 3n, 3r); ``test_torch_march_vjp.py``
holds the plain version against the JAX package.  Inputs are seeded with
numpy, at small shapes."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.ops import march, march_vjp
from volumerenderingproject_tpu_torch.scene.transfer_function import (
    from_text)
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

# K4 against its plain version: regrouped float sums, per element and of the
# largest component
RTOL_BWD = 1e-5


def _odd():
    """9x11x10, intensities in [-40, 255), cal_max 200.9."""
    rng = np.random.default_rng(12)
    return P.make_volume(rng.uniform(-40, 255, (9, 11, 10)).astype(np.float32),
                         cal_max=200.9, device="cpu")


def _slabbed():
    """12x11x10: 2 slabs of 6 planes, 4 of 3."""
    rng = np.random.default_rng(21)
    return P.make_volume(rng.uniform(-40, 255, (12, 11, 10))
                         .astype(np.float32), cal_max=200.9, device="cpu")


def _deep():
    """24x20x512: L = 512, so a voxel is 1/512 of the ray space and the
    spans' arithmetic works at its finest scale."""
    rng = np.random.default_rng(5)
    return P.make_volume(rng.uniform(0, 255, (24, 20, 512))
                         .astype(np.float32), device="cpu")


def _mc():
    """A 3-channel 10x11x9 volume."""
    rng = np.random.default_rng(31)
    return P.make_volume(rng.uniform(-30, 255, (10, 11, 9, 3))
                         .astype(np.float32), device="cpu")


def _narrow(position):
    """A camera at ``position`` with a 0.25-wide screen, whose rays cover
    the deep volume's thin x and y extents."""
    return lambda: P.Camera.initial(position=position, screen_w=0.25,
                                    screen_h=0.25, device="cpu")


def _away(position):
    """A camera at ``position`` that looks away from the volume: every ray
    misses the box."""
    c = P.Camera.initial(position=position, device="cpu")
    return P.Camera(c.position, -c.front, c.right, c.up, c.top_left)


SMALL = RenderConfig(width=61, height=37, samples_per_ray=37)
SLAB_CFG = RenderConfig(width=48, height=40, samples_per_ray=40)
NEAR = (0.35, 0.45, 0.85)
ORBIT = (1.5 * np.cos(0.7), 0.4 + 0.2 * np.sin(1.4), 1.5 * np.sin(0.7))
ALONG_X = (1.3, 0.02, 0.03)

# name -> (volume, camera position or camera, config)
SCENES = {
    "odd_ortho_orbit": (_odd, ORBIT, SMALL),
    "odd_conic": (_odd, NEAR, SMALL.replace(conic=True)),
    "odd_front_clip": (_odd, NEAR, SMALL.replace(front_clip=0.5)),
    "odd_camera_inside_conic": (_odd, (0.1, 0.05, 0.2),
                                SMALL.replace(conic=True)),
    "odd_camera_inside_ortho": (_odd, (0.1, 0.05, 0.2), SMALL),
    # axis-parallel ortho rays (d = (0, 0, -1))
    "odd_axis_parallel": (_odd, (0.0, 0.0, 1.2), SMALL),
    "odd_all_rays_miss_ortho": (_odd, lambda: _away((0.9, 0.5, 1.0)), SMALL),
    "odd_all_rays_miss_conic": (_odd, lambda: _away((0.9, 0.5, 1.0)),
                                SMALL.replace(conic=True)),
    # 2 / 6 of the ray space a step: 3.7 voxels
    "odd_step_longer_than_a_voxel": (_odd, NEAR, SMALL.replace(
        samples_per_ray=6)),
    "deep_ortho_along_x": (_deep, _narrow((1.2, 0.01, 0.02)), RenderConfig(
        width=32, height=24, samples_per_ray=700)),
    "deep_conic_orbit": (_deep, _narrow(ORBIT), RenderConfig(
        width=32, height=24, samples_per_ray=700, conic=True)),
    "slabbed_ortho_orbit": (_slabbed, ORBIT, SLAB_CFG),
    "slabbed_ortho_along_x": (_slabbed, ALONG_X, SLAB_CFG),
    "slabbed_conic": (_slabbed, NEAR, SLAB_CFG.replace(conic=True)),
}


def _units(shape, cfg, dims):
    """The work-unit keywords of ``march.prepare`` for every unit of a
    (rays, samples, volume) mesh of ``shape``, as parallel/render_dist.py
    cuts it."""
    n_r, n_s, n_v = shape
    w, s = cfg.width // n_r, cfg.samples_per_ray // n_s
    slab = dims[0] // n_v if n_v > 1 else 0
    out = []
    for r in range(n_r):
        for si in range(n_s):
            for v in range(n_v):
                kw = dict(x_offset=r * w, local_width=w, s_start=si * s,
                          s_count=s, segment=True)
                if slab:
                    kw.update(x0=v * slab, slab_x=slab)
                out.append(kw)
    return out


# unit cases: (scene, mesh); the slabs of (1, 2, 2) and (1, 1, 4) (the
# first, the interior and the last slab), the sample windows of (1, 4, 1)
UNITS = [(scene, shape) for scene in ("slabbed_ortho_orbit",
                                      "slabbed_ortho_along_x",
                                      "slabbed_conic")
         for shape in ((1, 2, 2), (1, 1, 4), (1, 4, 1))]


def _scene(name, tf=None, **cfg_kw):
    make_vol, cam, cfg = SCENES[name]
    cam = cam() if callable(cam) else P.Camera.initial(position=cam,
                                                       device="cpu")
    tf = P.default_transfer_function(device="cpu") if tf is None else tf
    return make_vol(), tf, cam, cfg.replace(**cfg_kw)


def _args(name, tf=None, unit=None, **cfg_kw):
    return march_vjp.prepare_diff(*_scene(name, tf, **cfg_kw),
                                  **(unit or {}))[0]


def _window(a):
    return range(a.s_start, a.s_start + a.spr)


def _chains(a):
    """bool [W, H, spr] each: whether sample i's chain gives a voxel (in the
    volume and, on a slab, owned) and whether the unit owns it."""
    o, d = march._rays(a, a.x_offset, a.full_width)
    ids_at = march._sample_ids(a, o, d)
    valid, owned = [], []
    for i in _window(a):
        _, v, _, ijk = ids_at(i)
        valid.append(v)
        owned.append(march.owned_by(a, ijk) if a.slab_x else
                     torch.ones_like(v))
    return torch.stack(valid, -1), torch.stack(owned, -1)


def _masks(a, r=None):
    """bool [W, H, spr] each: the samples K4 visits, and those it runs the
    full chain on."""
    r = march_vjp.sample_range(a) if r is None else r
    return (torch.stack([r.visits(i) for i in _window(a)], -1),
            torch.stack([r.full(i) for i in _window(a)], -1))


def _check_spans(a, r=None):
    """The properties the module docstring lists -> (valid, chain span)."""
    r = march_vjp.sample_range(a) if r is None else r
    valid, owned = _chains(a)
    visits, full = _masks(a, r)
    chain = _span_mask(a, r.chain_lo, r.chain_hi)
    assert not bool((valid & ~chain).any()), (
        f"{int((valid & ~chain).sum())} samples with a voxel outside the "
        "chain's span")
    assert not bool((owned & ~visits).any()), (
        f"{int((owned & ~visits).sum())} owned samples not visited")
    const = visits & ~full
    assert not bool((const & ~owned).any()), (
        f"{int((const & ~owned).sum())} constant samples another slab owns")
    assert not bool((const & valid).any())
    return valid, chain


@pytest.mark.parametrize("name", sorted(SCENES))
def test_no_sample_with_a_voxel_lies_outside_the_chain_span(name):
    a = _args(name)
    valid, chain = _check_spans(a)
    # and the span is tight: on average a ray's span holds at most 8 samples
    # more than those with a voxel (floor, ceil, one sample at each end, the
    # pad, and the box's extra leaf 1/n on each upper face, pallas_march.py:
    # 1709-1716)
    hit = chain.any(-1)
    extra = (chain.sum(-1) - valid.sum(-1))[hit]
    assert int(extra.sum()) <= 8 * extra.numel(), float(extra.float().mean())
    if "all_rays_miss" in name:
        assert not bool(chain.any())
    else:
        assert bool(valid.any())


@pytest.mark.parametrize("scene,shape", UNITS)
def test_units_visit_every_owned_sample(scene, shape):
    """Every unit of the mesh; on a slab also that the units' visited
    samples partition nothing away: each sample is owned by one slab."""
    vol, tf, cam, cfg = _scene(scene)
    owners = None
    for kw in _units(shape, cfg, vol.dims):
        a = march_vjp.prepare_diff(vol, tf, cam, cfg, **kw)[0]
        _check_spans(a)
        if shape == (1, 1, 4):
            owned = _chains(a)[1].int()
            owners = owned if owners is None else owners + owned
    if owners is not None:
        assert bool((owners == 1).all())


def _face_rays(face: int, side: int, oblique: bool, plane=None, unit=None):
    """Ortho rays on the 12x11x10 volume whose origins step by 2^-24 of the
    ray space (an ulp there) across the plane where the chain's voxel index
    of axis ``face`` flips (side 0: to 0 from -1, side 1: to dim from
    dim - 1), or across ``plane`` (ray space) when given: the samples there
    have a voxel, or are owned, or not by the last bit of the chain, which
    the spans must never get wrong.  Rays run along z (axis-parallel) or
    obliquely, crossing the plane at z = 0, inside the box."""
    a = _args("slabbed_ortho_orbit", unit=unit)
    L = float(max(a.dims))
    n = float(2 ** a.depth)
    if plane is None:
        hg = L / 2 - a.dims[face] / 2
        edge = hg + (0 if side == 0 else a.dims[face])
        # the leaf boundary where floor(p n) / n * L crosses the edge
        plane = np.ceil(edge / L * n) / n - 0.5
    step = 2.0 ** -24
    d = np.array([0.0, 0.0, -1.0])
    if oblique:
        d[face] = 0.3 if side == 0 else -0.3
        d[1 - face] = 0.1
    d = d / np.linalg.norm(d)
    t_mid = 1.2 / -d[2]  # where the rays reach z = 0
    tl = [0.01 - d[0] * t_mid, -0.02 - d[1] * t_mid, 1.2]
    tl[face] = plane - d[face] * t_mid - 32 * step
    axis = np.zeros(3)
    axis[face] = step
    other = np.zeros(3)
    other[1 - face] = 1e-3
    s = a.scal.clone()
    s[march.S_TL:march.S_TL + 3] = torch.tensor(tl)
    s[march.S_FRONT:march.S_FRONT + 3] = torch.tensor(d)
    s[march.S_RIGHT:march.S_RIGHT + 3] = torch.tensor(axis)  # x: one step
    s[march.S_UP:march.S_UP + 3] = torch.tensor(-other)  # y: 1e-3 across
    s[march.S_RSW], s[march.S_RSH] = 64.0, 8.0
    return a._replace(scal=s, width=64, height=8, spr=400, conic=False,
                      x_offset=0, full_width=0, s_start=0)


@pytest.mark.parametrize("oblique", [False, True])
@pytest.mark.parametrize("face,side", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_rays_on_the_faces_of_the_box(face, side, oblique):
    a = _face_rays(face, side, oblique)
    valid, _ = _check_spans(a)
    assert bool(valid.any()) and not bool(valid.all(-1).all(-1).all())
    if not oblique:  # the face is crossed: some rays have a voxel, some not
        on_face = valid.any(-1)
        assert bool(on_face.any()) and not bool(on_face.all())


@pytest.mark.parametrize("oblique", [False, True])
@pytest.mark.parametrize("v", [0, 1])
def test_rays_on_the_plane_between_two_slabs(v, oblique):
    """Rays stepped across x plane 6, where slab 0 of (1, 1, 2) hands its
    samples to slab 1; for both slabs, on either side."""
    vol = _slabbed()
    L = float(max(vol.dims))
    n = float(2 ** vol.octree_depth)
    plane = np.ceil((L / 2 - vol.dims[0] / 2 + 6) / L * n) / n - 0.5
    unit = dict(x0=6 * v, slab_x=6, segment=True)
    a = _face_rays(0, 1 - v, oblique, plane=plane, unit=unit)
    _, owned = _chains(a)
    _check_spans(a)
    assert bool(owned.any()) and not bool(owned.all())


def test_every_sample_runs_the_chain_where_the_ray_is_not_finite():
    for unit in (None, dict(x0=6, slab_x=6, segment=True)):
        a = _args("slabbed_conic", unit=unit)
        s = a.scal.clone()
        s[march.S_POS] = float("nan")
        r = march_vjp.sample_range(a._replace(scal=s))
        assert bool((r.lo == 0).all()) and bool((r.hi == a.spr - 1).all())
        assert all(bool(r.full(i).all()) for i in _window(a))


def _span_mask(a, lo, hi):
    return torch.stack([(i >= lo) & (i <= hi) for i in _window(a)], -1)


def _near_parallel_rays(face: int, side: int, d_face: float):
    """Rays that run within ``d_face`` of parallel to a face of the box and
    cross its plane along the ray, spread over two units of t: there the
    position's last bit moves the crossing by ulp / d_face in t, 0.6 at
    1e-7, some ten samples."""
    a = _face_rays(face, side, False)
    s = a.scal.clone()
    d = np.array([0.0, 0.0, -1.0])
    d[face] = d_face if side == 0 else -d_face  # inwards
    s[march.S_FRONT:march.S_FRONT + 3] = torch.tensor(d / np.linalg.norm(d))
    # the rays reach the plane at t in (-0.8, 1.2]; z = 0 at t = 1.2
    s[march.S_RIGHT:march.S_RIGHT + 3] = 0.0
    s[march.S_RIGHT + face] = d[face] * 2.0 / 64
    s[march.S_TL + face] = (s[march.S_TL + face] + 32 * 2.0 ** -24
                            - d[face] * 1.2)
    # samples to t = 2, past the volume (z = 0 at t = 1.2)
    spr = int(2.0 / float(s[march.S_DS])) + 2
    return a._replace(scal=s, spr=spr)


NEAR_PARALLEL = [(f, s, dv) for f in (0, 1) for s in (0, 1)
                 for dv in (1e-5, 1e-7)]


@pytest.mark.parametrize("face,side,d_face", NEAR_PARALLEL)
def test_rays_nearly_parallel_to_a_face(face, side, d_face):
    a = _near_parallel_rays(face, side, d_face)
    valid, _ = _check_spans(a)
    assert bool(valid.any()) and not bool(valid.all())


def test_an_unpadded_clip_misses_samples_on_nearly_parallel_rays():
    """K1's clip before it took the pad (the box's span with one sample of
    slop and nothing more) loses samples that have a voxel on rays within
    1e-7 of parallel to the box's low x face: why both marches pad it."""
    a = _near_parallel_rays(0, 0, 1e-7)
    o, d = march._rays(a)
    s = a.scal
    lo, hi = march.box_span(
        o, d, s[march.S_BOX_LO:march.S_BOX_LO + 3],
        s[march.S_BOX_HI:march.S_BOX_HI + 3], torch.zeros(o.shape[:2]),
        s[march.S_DS], s[march.S_CLIP], False)
    valid, _ = _chains(a)
    assert int((valid & ~_span_mask(a, lo, hi)).sum()) > 0
    r = march_vjp.sample_range(a)
    assert not bool((valid & ~_span_mask(a, r.chain_lo, r.chain_hi)).any())


# ---- the fold ---------------------------------------------------------------

def _range_bwd(a, g_rgb, g_t):
    """K4's two passes on its spans: the full chain where ``full``, the
    constant (k0, a0, g . c'0) on the other visited samples, skipped runs of
    them in pass A where a0 == 0; in pass B the constant samples' w, T and
    numerator summed and folded into interval k0 once per ray, T gd0 - num
    / (1 - a0) with one division (where a0 == 0 a run's dL/da at once, its
    length times its dL/da); per interval the sums of
    w M and dL/da, the rgb columns g times the first -> each ray's
    [W * H, K, 4]; the kernel's partials add them up."""
    r = march_vjp.sample_range(a)
    o, d = march._rays(a, a.x_offset, a.full_width)
    ids_at = march._sample_ids(a, o, d)
    lut = a.itv is not None
    itv = a.itv.long() if lut else None
    colors = a.colors
    k = colors.shape[0]
    baked, mc = a.mgrid is not None, a.chans is not None
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]
    one, zero = torch.ones(()), torch.zeros(())

    def sample(i):  # march_bwd_plain's
        sid, valid, flat, ijk = ids_at(i)
        mid = itv[sid] if lut else sid
        rgba = colors[mid]
        c = [rgba[..., 0], rgba[..., 1], rgba[..., 2]]
        m = one
        if baked:
            m = torch.where(valid, a.mgrid.reshape(-1)[flat], one)
            sh = torch.where(valid, a.sgrid.reshape(-1)[flat], zero)
            c = [x * m + sh for x in c]
        elif mc:
            ch = torch.where(valid, a.chans.reshape(a.chans.shape[0], -1)
                             [:, flat], zero)
            c = [ch[0]] * 3 if ch.shape[0] == 1 else list(ch)
        alpha = rgba[..., 3]
        if a.slab_x:
            owned = march.owned_by(a, ijk)
            alpha = torch.where(owned, alpha, zero)
            mid = torch.where(owned, mid, -1)
        return mid, alpha, (gr * c[0] + gg * c[1]) + gb * c[2], m

    id0 = int(a.scal[march.S_ID0])
    k0 = int(itv[id0]) if lut else id0
    c0 = colors[k0].clone()
    if baked:
        c0[:3] = c0[:3] * 1.0 + 0.0
    elif mc:
        c0[:3] = 0.0
    a0 = c0[3]
    gd0 = (gr * c0[0] + gg * c0[1]) + gb * c0[2]
    a0_zero = bool(a0 == 0.0)

    shape = (a.width, a.height)
    t, total = torch.ones(shape), torch.zeros(shape)
    for i in _window(a):  # pass A
        full, vis = r.full(i), r.visits(i)
        _, alpha, gd, _ = sample(i)
        alpha, gd = torch.where(full, alpha, a0), torch.where(full, gd, gd0)
        upd = full | (vis & (not a0_zero))
        total = torch.where(upd, total + (t * alpha) * gd, total)
        t = torch.where(upd, t * (1.0 - alpha), t)
    bg_term = t * g_t

    sw = torch.zeros((a.width * a.height, k + 1))  # column k: no interval
    sa = torch.zeros((a.width * a.height, k + 1))
    ow, oda = torch.zeros(shape), torch.zeros(shape)
    run_n, run_da = torch.zeros(shape), torch.zeros(shape)
    ot, onum = torch.zeros(shape), torch.zeros(shape)
    t, pfx = torch.ones(shape), torch.zeros(shape)
    window = list(_window(a))
    for n, i in enumerate(window):  # pass B
        full, vis = r.full(i), r.visits(i)
        const = vis & ~full
        mid, alpha, gd, m = sample(i)
        alpha, gd = torch.where(full, alpha, a0), torch.where(full, gd, gd0)
        upd = full | (const & (not a0_zero))
        t_s = t
        w = t * alpha
        pfx_new = pfx + w * gd
        num = (total - pfx_new) + bg_term
        denom = 1.0 - alpha
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        if a0_zero:  # a run's dL/da, with T and the prefix as they are
            da = torch.where(const, t * gd0 - ((total - pfx) + bg_term), da)
        pfx = torch.where(upd, pfx_new, pfx)
        t = torch.where(upd, t * denom, t)
        wm = w * m if baked else w
        col = torch.where(full & (mid >= 0), mid, k).reshape(-1, 1)
        sw.scatter_add_(1, col, torch.where(full, wm, zero).reshape(-1, 1))
        sa.scatter_add_(1, col, torch.where(full, da, zero).reshape(-1, 1))
        if a0_zero:
            run_n = torch.where(const, run_n + 1.0, run_n)
            run_da = torch.where(const, da, run_da)
            last = n + 1 == len(window)
            ends = const & (torch.ones_like(const) if last else
                            ~(r.visits(i + 1) & ~r.full(i + 1)))
            oda = torch.where(ends, oda + run_n * run_da, oda)
            run_n = torch.where(ends, zero, run_n)
        else:
            ow = torch.where(const, ow + w, ow)
            ot = torch.where(const, ot + t_s, ot)
            onum = torch.where(const, onum + num, onum)
    if not a0_zero:  # sum T gd0 - num / (1 - a0), one division a ray
        denom0 = 1.0 - a0
        oda = oda + (gd0 * ot - (onum / denom0 if bool(denom0 != 0.0)
                                 else zero))
    sw[:, k0] += ow.reshape(-1)
    sa[:, k0] += oda.reshape(-1)
    sw, sa = sw[:, :k], sa[:, :k]
    if mc:
        rgb = torch.zeros((a.width * a.height, k, 3))
    else:
        rgb = torch.stack([gr.reshape(-1, 1) * sw, gg.reshape(-1, 1) * sw,
                           gb.reshape(-1, 1) * sw], -1)
    return torch.cat([rgb, sa[..., None]], -1)


def _tf16():
    rng = np.random.default_rng(16)
    lo = np.sort(rng.uniform(0.0, 0.9, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.2, 16)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    colors[:, 3] *= np.float32(0.7)
    return P.TransferFunction(*(torch.tensor(v) for v in (
        lo, hi, colors, np.zeros(16, np.float32))))


def _alpha0(alpha):
    """The default TF with TF(0).alpha (the interval of intensity 0, which
    every sample off the volume takes) set to ``alpha``."""
    def make():
        tf = P.default_transfer_function(device="cpu")
        colors = tf.colors.clone()
        colors[0, 3] = alpha
        return P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)
    return make


def _k2():
    return from_text("low 0 0.4 0.2 0.3 0.4 0.3\n"
                     "high 0.4 1 0.9 0.8 0.7 0.6\n", device="cpu")


# case -> (scene, keywords of _args; a TF as a function that makes it)
BWD_CASES = {
    "plain_orbit": ("odd_ortho_orbit", {}),
    "plain_conic": ("odd_conic", {}),
    "plain_camera_inside": ("odd_camera_inside_conic", {}),
    "plain_axis_parallel": ("odd_axis_parallel", {}),
    "plain_all_rays_miss": ("odd_all_rays_miss_ortho", {}),
    "plain_long_step": ("odd_step_longer_than_a_voxel", {}),
    "plain_front_clip_k2": ("odd_front_clip", dict(tf=_k2)),
    "plain_k16": ("odd_ortho_orbit", dict(tf=_tf16)),
    "lut": ("odd_ortho_orbit", dict(tf_lut=64)),
    "lut_conic": ("odd_conic", dict(tf_lut=256)),
    "baked": ("odd_ortho_orbit", dict(lighting=True)),
    "lut_baked": ("odd_front_clip", dict(tf_lut=64, lighting=True)),
    "alpha0_negative": ("odd_ortho_orbit", dict(tf=_alpha0(-3e-5))),
    "alpha0_0.05": ("odd_conic", dict(tf=_alpha0(0.05))),
    "alpha0_one": ("odd_ortho_orbit", dict(tf=_alpha0(1.0))),
    "alpha0_one_lut": ("odd_ortho_orbit", dict(tf=_alpha0(1.0), tf_lut=64)),
    "deep_along_x": ("deep_ortho_along_x", {}),
}
UNIT_CASES = {
    "slab_orbit_122": ("slabbed_ortho_orbit", (1, 2, 2), {}),
    "slab_along_x_114": ("slabbed_ortho_along_x", (1, 1, 4), {}),
    "slab_baked_122": ("slabbed_ortho_orbit", (1, 2, 2),
                       dict(lighting=True)),
    "slab_alpha0_0.05_114": ("slabbed_ortho_along_x", (1, 1, 4),
                             dict(tf=_alpha0(0.05))),
    "segment_141": ("slabbed_conic", (1, 4, 1), {}),
    "segment_alpha0_one_141": ("slabbed_ortho_orbit", (1, 4, 1),
                               dict(tf=_alpha0(1.0))),
}


def _cotangents(a, seed=13):
    rng = np.random.default_rng(seed)
    scale = np.float32(1.0 / (a.width * a.height))
    return (torch.tensor(rng.normal(0.0, 1.0, (a.width, a.height, 3))
                         .astype(np.float32) * scale),
            torch.tensor(rng.normal(0.0, 1.0, (a.width, a.height))
                         .astype(np.float32) * scale))


def _plain_per_ray(a, g_rgb, g_t):
    """march_bwd_plain's per-sample terms (float32, in its float order)
    summed per ray and interval in float64 -> [W * H, K, 4]: the sums that
    both float orders of the same terms, the plain version's sample by
    sample and the fold's, approximate."""
    return march_vjp.march_bwd_plain(a, g_rgb, g_t, per_ray=True)


def _assert_fold(a, vs_plain=True):
    """Each ray's fold within RTOL_BWD of the largest per-ray sum of the
    float64 sums of the plain version's terms (the regrouping, without the
    rays' sum, whose float32 rounding both orders share); with
    ``vs_plain`` the rays' total within RTOL_BWD of max |dplain| of
    march_bwd_plain itself."""
    g = _cotangents(a)
    got = _range_bwd(a, *g)
    exact = _plain_per_ray(a, *g)
    scale = float(exact.abs().max())
    if scale == 0.0:  # a unit that owns no sample with a gradient
        assert float(got.abs().max()) == 0.0
        assert float(march_vjp.march_bwd_plain(a, *g).abs().max()) == 0.0
        return
    torch.testing.assert_close(got.double(), exact, rtol=RTOL_BWD,
                               atol=RTOL_BWD * scale)
    if vs_plain:
        want = march_vjp.march_bwd_plain(a, *g)
        torch.testing.assert_close(got.sum(0), want, rtol=RTOL_BWD,
                                   atol=RTOL_BWD * float(want.abs().max()))


def _kw(kw):
    kw = dict(kw)
    if "tf" in kw:
        kw["tf"] = kw["tf"]()
    return kw


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_fold_matches_the_plain_backward(case):
    name, kw = BWD_CASES[case]
    a = _args(name, **_kw(kw))
    _assert_fold(a)


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_fold_matches_the_plain_backward_on_units(case):
    name, shape, kw = UNIT_CASES[case]
    kw = _kw(kw)
    tf = kw.pop("tf", None)
    vol, tf, cam, cfg = _scene(name, tf, **kw)
    for unit in _units(shape, cfg, vol.dims):
        a = march_vjp.prepare_diff(vol, tf, cam, cfg, **unit)[0]
        # march_bwd_plain's float32 sums of its terms leave 2.8e-5 of max
        # |d| from their float64 sums on a slab of (1, 2, 2) (x0 = 6,
        # samples 0-19), the fold's 3.2e-6: each unit's fold is held to
        # the float64 sums, ray by ray
        _assert_fold(a, vs_plain=False)


def test_fold_matches_the_plain_backward_multichannel():
    a = march_vjp.prepare_diff(_mc(), P.default_transfer_function(
        device="cpu"), P.Camera.initial(position=ORBIT, device="cpu"),
        SMALL)[0]
    assert march.variant(a) == "mc"
    _assert_fold(a)


def test_the_constant_is_the_chain_of_a_sample_off_the_volume():
    """What K4 gives a constant sample (interval k0, c'0, a0) is what the
    chain gives a sample off the volume, in every variant: on the all-miss
    scene every sample is constant, so the fold must match there too, LUT
    and baked included."""
    for kw in ({}, dict(tf_lut=64), dict(lighting=True),
               dict(tf=_alpha0(0.3))):
        a = _args("odd_all_rays_miss_ortho", **_kw(kw))
        r = march_vjp.sample_range(a)
        assert not any(bool(r.full(i).any()) for i in _window(a))
        _assert_fold(a)


@pytest.mark.parametrize("case", ["odd_ortho_orbit", "odd_conic"])
def test_the_per_ray_sums_add_up_to_the_plain_backward(case):
    """march_bwd_plain's float64 per-ray sums (what chip_smoke.py holds the
    kernel's per-block partials to) add up to its float32 dL/dcolors, and
    their block sums keep the total in the rows of the kernel's partials:
    ray (px, py) in block (px // BLOCK_X) * ceil(H / BLOCK_Y) + py //
    BLOCK_Y."""
    a = _args(case, _alpha0(0.05)() if case == "odd_conic" else None)
    g = _cotangents(a)
    per_ray = march_vjp.march_bwd_plain(a, *g, per_ray=True)
    want = march_vjp.march_bwd_plain(a, *g)
    assert per_ray.dtype == torch.float64
    assert per_ray.shape == (a.width * a.height,) + tuple(want.shape)
    torch.testing.assert_close(per_ray.sum(0).float(), want, rtol=RTOL_BWD,
                               atol=RTOL_BWD * float(want.abs().max()))
    blocks = march_vjp.block_sums(per_ray, a.width, a.height)
    assert blocks.shape[0] == march_vjp.num_blocks(a.width, a.height)
    torch.testing.assert_close(blocks.sum(0), per_ray.sum(0), rtol=1e-12,
                               atol=1e-15)
    # one ray's sums land in its block's row alone
    px, py = a.width - 1, a.height - 1
    one = torch.zeros_like(per_ray)
    one[px * a.height + py] = per_ray[px * a.height + py]
    row = ((px // march_vjp.BLOCK_X) * -(-a.height // march_vjp.BLOCK_Y)
           + py // march_vjp.BLOCK_Y)
    got = march_vjp.block_sums(one, a.width, a.height)
    assert torch.equal(got[row], one[px * a.height + py])
    assert float(got.abs().sum()) == float(one[px * a.height + py].abs()
                                           .sum())
