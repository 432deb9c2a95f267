"""Each ray's sample range in the smooth marches (``ops/smooth.sample_range``,
the mirror of ``smooth_sample_range`` in csrc/smooth_common.cuh, in its
float order).  The kernels evaluate only the samples of that range and give
every other sample the RGBA of intensity 0, ``classify(0 / cal_max)``.
That is exact only if no sample outside the range has a corner in the
volume; these tests hold the range to that on the scenes where it is
easiest to get wrong, then check what the kernels build on it:

- a march that composites that constant outside the range equals
  ``march_smooth_plain`` bit for bit (K8's loop);
- a backward march that sums the off-range samples' w_s and dL/da and folds
  the two sums into the intervals once per ray stays within rtol 1e-5 of
  ``march_smooth_bwd_plain`` (K9's regrouping; its volume gradient is
  bit-equal, since an off-range sample splats nothing).

The kernels themselves are held against the plain versions on the card by
chip_smoke.py (phases 3g, 3h, 3k); ``test_torch_smooth.py`` and
``test_torch_smooth_vjp.py`` hold the plain versions against the JAX
package.  Inputs are seeded with numpy, at small shapes."""

import dataclasses

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.ops import smooth, smooth_vjp
from volumerenderingproject_tpu_torch.scene.transfer_function import (
    from_text)
from volumerenderingproject_tpu_torch.utils.config import Interp, RenderConfig

# K9 against its plain version: regrouped float sums, per element and of the
# largest component
RTOL_BWD = 1e-5


def _odd():
    """9x11x10, intensities in [-40, 255), cal_max 200.9 (chip_smoke.py's
    smooth edge volume)."""
    rng = np.random.default_rng(12)
    return P.make_volume(rng.uniform(-40, 255, (9, 11, 10)).astype(np.float32),
                         cal_max=200.9, device="cpu")


def _deep():
    """24x20x512: a 512-deep volume, L = 512, so a voxel is 1/512 of the
    ray space and the range's arithmetic works at its finest scale."""
    rng = np.random.default_rng(5)
    return P.make_volume(rng.uniform(0, 255, (24, 20, 512))
                         .astype(np.float32), device="cpu")


def _narrow(position):
    """A camera at ``position`` with a 0.25-wide screen, whose rays cover
    the deep volume's thin x and y extents (24 / 512 and 20 / 512)."""
    return lambda: P.Camera.initial(position=position, screen_w=0.25,
                                    screen_h=0.25, device="cpu")


def _away(position):
    """A camera at ``position`` that looks away from the volume: every ray
    misses the box."""
    c = P.Camera.initial(position=position, device="cpu")
    return P.Camera(c.position, -c.front, c.right, c.up, c.top_left)


SMALL = RenderConfig(width=61, height=37, samples_per_ray=37,
                     interp=Interp.TRILINEAR)
NEAR = (0.35, 0.45, 0.85)
ORBIT = (1.5 * np.cos(0.7), 0.4 + 0.2 * np.sin(1.4), 1.5 * np.sin(0.7))

# name -> (volume, camera position or camera, config)
SCENES = {
    "odd_ortho_orbit": (_odd, ORBIT, SMALL),
    "odd_conic": (_odd, NEAR, SMALL.replace(conic=True)),
    "odd_conic_uncorrected": (_odd, NEAR, SMALL.replace(
        conic=True, conic_corrected=False)),
    "odd_front_clip": (_odd, NEAR, SMALL.replace(front_clip=0.5)),
    "odd_camera_inside_conic": (_odd, (0.1, 0.05, 0.2),
                                SMALL.replace(conic=True)),
    "odd_camera_inside_ortho": (_odd, (0.1, 0.05, 0.2), SMALL),
    # axis-parallel ortho rays (d = (0, 0, -1)): columns in the -1 band of
    # the x and y faces (chip_smoke.py's grazing_entry_faces)
    "odd_grazing_entry_faces": (_odd, (0.0, 0.0, 1.2), SMALL),
    "odd_all_rays_miss_ortho": (_odd, lambda: _away((0.9, 0.5, 1.0)), SMALL),
    "odd_all_rays_miss_conic": (_odd, lambda: _away((0.9, 0.5, 1.0)),
                                SMALL.replace(conic=True)),
    # 2 / 6 of the ray space a step: 3.7 voxels
    "odd_step_longer_than_a_voxel": (_odd, NEAR, SMALL.replace(
        samples_per_ray=6)),
    "deep_ortho_along_x": (_deep, _narrow((1.2, 0.01, 0.02)), RenderConfig(
        width=32, height=24, samples_per_ray=700, interp=Interp.TRILINEAR)),
    "deep_conic_orbit": (_deep, _narrow(ORBIT), RenderConfig(
        width=32, height=24, samples_per_ray=700, interp=Interp.TRILINEAR,
        conic=True)),
}


def _scene(name, tf=None, **cfg_kw):
    """(volume, tf, camera, config) of scene ``name``; the default TF
    unless ``tf`` is given, config fields replaced by ``cfg_kw``."""
    make_vol, cam, cfg = SCENES[name]
    cam = cam() if callable(cam) else P.Camera.initial(position=cam,
                                                       device="cpu")
    tf = P.default_transfer_function(device="cpu") if tf is None else tf
    return make_vol(), tf, cam, cfg.replace(**cfg_kw)


def _args(name, eps=0.0, tf=None, **cfg_kw):
    return smooth.prepare_smooth(*_scene(name, tf, **cfg_kw), eps)


def _touches(a):
    """bool [W, H, spr]: whether sample i of each ray has a corner in the
    volume, at the position the kernels' chain gives it."""
    o, d = smooth.march._rays(a)
    vox_at = smooth._voxel_positions(a, o, d)
    return torch.stack([smooth.touches_volume(vox_at(i), a.dims)
                        for i in range(a.spr)], dim=-1)


def _in_range(a):
    i_lo, i_hi = smooth.sample_range(a)
    i = torch.arange(a.spr)
    return (i >= i_lo[..., None]) & (i <= i_hi[..., None])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_no_sample_outside_the_range_touches_the_volume(name):
    a = _args(name)
    touch = _touches(a)
    inside = _in_range(a)
    assert not bool((touch & ~inside).any()), (
        f"{int((touch & ~inside).sum())} samples outside the range touch "
        f"the volume")
    # and the range is tight: on average a ray's range holds at most 5
    # samples more than those that touch (floor, ceil, one sample at each
    # end, the pad)
    hit = inside.any(-1)
    extra = (inside.sum(-1) - touch.sum(-1))[hit]
    assert int(extra.sum()) <= 5 * extra.numel(), float(extra.float().mean())
    if name.startswith("odd_all_rays_miss"):
        assert not bool(inside.any())
    elif name != "odd_conic_uncorrected":  # the reference's missing rays
        assert bool(touch.any())


def _face_rays(face: int, side: int, oblique: bool):
    """Ortho rays on the 9x11x10 volume whose origins step by 2^-24 of the
    ray space (an ulp there, 7e-7 voxel) across the plane where vox of
    axis ``face`` is -1 (side 0) or dim (side 1): the samples there touch
    the volume or not by the last bit of the chain, which the range must
    never get wrong.
    Rays run along z (axis-parallel: x and y are not divided by) or
    obliquely, crossing the plane at z = 0, inside the box."""
    a = _args("odd_ortho_orbit")
    L = float(max(a.dims))
    voff = a.dims[face] / 2.0 - L / 2.0
    plane = ((-1.0 if side == 0 else a.dims[face]) - voff) / L - 0.5
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
    m = smooth.march
    s = a.scal.clone()
    s[m.S_TL:m.S_TL + 3] = torch.tensor(tl)
    s[m.S_FRONT:m.S_FRONT + 3] = torch.tensor(d)
    s[m.S_RIGHT:m.S_RIGHT + 3] = torch.tensor(axis)  # x pixel: one step
    s[m.S_UP:m.S_UP + 3] = torch.tensor(-other)  # y pixel: 1e-3 across
    s[m.S_RSW], s[m.S_RSH] = 64.0, 8.0
    return a._replace(scal=s, width=64, height=8, spr=400, conic=False)


@pytest.mark.parametrize("oblique", [False, True])
@pytest.mark.parametrize("face,side", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_rays_on_the_faces_of_the_box(face, side, oblique):
    a = _face_rays(face, side, oblique)
    touch = _touches(a)
    inside = _in_range(a)
    assert bool(touch.any()) and not bool(touch.all(-1).all(-1).all())
    assert not bool((touch & ~inside).any()), int((touch & ~inside).sum())


def test_range_is_the_whole_ray_where_the_ray_is_not_finite():
    a = _args("odd_conic")
    s = a.scal.clone()
    s[smooth.march.S_POS] = float("nan")
    i_lo, i_hi = smooth.sample_range(a._replace(scal=s))
    assert bool((i_lo == 0).all()) and bool((i_hi == a.spr - 1).all())


def _rgba0(a):
    """classify(0 / cal_max): the RGBA of every sample outside the range."""
    zero = torch.zeros((), dtype=torch.float32)
    return smooth.smooth_classify(a, zero / a.scal[smooth.S_CAL_MAX])


def _range_march(a):
    """K8's loop: the full chain inside each ray's range, the constant
    RGBA outside it, the same compositing and early stop."""
    sample = smooth.sample_fn(a)
    inside = _in_range(a)
    rgba0 = _rgba0(a)[0]
    s = a.scal
    eps = s[smooth.S_EPS].clamp_min(0.0)
    c = torch.zeros((a.width, a.height, 3))
    t = torch.ones((a.width, a.height, 1))
    for i in range(a.spr):
        active = t.abs() > eps
        rgba = torch.where(inside[..., i:i + 1], sample(i)[0], rgba0)
        alpha = rgba[..., 3:4]
        c = torch.where(active, c + (t * alpha) * rgba[..., :3], c)
        t = torch.where(active, t * (1.0 - alpha), t)
    rgb = c + t * s[smooth.S_BG:smooth.S_BG + 3]
    return torch.cat([rgb, torch.ones((a.width, a.height, 1))], dim=-1)


def _tf16():
    rng = np.random.default_rng(16)
    lo = np.sort(rng.uniform(0.0, 0.9, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.2, 16)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    colors[:, 3] *= np.float32(0.7)
    return P.TransferFunction(*(torch.tensor(v) for v in (
        lo, hi, colors, np.zeros(16, np.float32))))


def _opaque():
    tf = P.default_transfer_function(device="cpu")
    colors = tf.colors.clone()
    colors[:, 3] = 1.0
    return P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


def _k2():
    return from_text("empty 0 1 0.1 0.2 0.3 0.05\n"
                     "bone 0.3 0.6 0.9 0.8 0.7 0.6\n", device="cpu")


# case -> (scene, keywords of _args; a TF as a function that makes it)
MARCH_CASES = {
    "odd_ortho_orbit": ("odd_ortho_orbit", {}),
    "odd_conic_eps1e-3": ("odd_conic", dict(eps=1e-3)),
    "odd_conic_s60": ("odd_conic", dict(tf_sharpness=60.0)),
    "odd_conic_s1000": ("odd_conic", dict(tf_sharpness=1000.0)),
    "odd_grazing_entry_faces": ("odd_grazing_entry_faces", {}),
    "odd_camera_inside_conic": ("odd_camera_inside_conic", {}),
    "odd_camera_inside_ortho_k2": ("odd_camera_inside_ortho",
                                   dict(tf=_k2)),
    "odd_all_rays_miss_conic": ("odd_all_rays_miss_conic", {}),
    "odd_step_longer_than_a_voxel": ("odd_step_longer_than_a_voxel", {}),
    "odd_front_clip_k16": ("odd_front_clip", dict(tf=_tf16)),
    "odd_conic_uncorrected_alpha_one": ("odd_conic_uncorrected",
                                        dict(tf=_opaque)),
    "deep_ortho_along_x": ("deep_ortho_along_x", {}),
}


@pytest.mark.parametrize("case", sorted(MARCH_CASES))
def test_range_march_is_bit_exact_to_the_plain_march(case):
    name, kw = MARCH_CASES[case]
    kw = dict(kw)
    if "tf" in kw:
        kw["tf"] = kw["tf"]()
    a = _args(name, **kw)
    want = smooth.march_smooth_plain(a)
    got = _range_march(a)
    assert torch.equal(got, want), float((got - want).abs().max())


def _range_bwd(a, g_rgb, g_t):
    """K9's two passes: the constant RGBA outside the range in pass A, and
    in pass B each off-range sample's w_s and dL/da summed and folded into
    the intervals once per ray with the constant's s1, s2 and w; the
    volume gradient splats the in-range samples only.  The rays' sums are
    added last, as the kernel's partials are."""
    k = a.colors.shape[0]
    sample = smooth.sample_fn(a)
    inside = _in_range(a)
    rgba0, s1_0, s2_0, w0 = _rgba0(a)
    sharp = a.scal[smooth.S_SHARP]
    cal = a.scal[smooth.S_CAL_MAX]
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]
    dk = a.colors[1:] - a.colors[0]
    gdk = ((gr[..., None] * dk[:, 0] + gg[..., None] * dk[:, 1])
           + gb[..., None] * dk[:, 2])

    def gdot(rgba):
        return (gr * rgba[..., 0] + gg * rgba[..., 1]) + gb * rgba[..., 2]

    shape = (a.width, a.height)
    t = torch.ones(shape)
    total = torch.zeros(shape)
    for i in range(a.spr):
        rgba = torch.where(inside[..., i:i + 1], sample(i)[0], rgba0)
        alpha = rgba[..., 3]
        total = total + (t * alpha) * gdot(rgba)
        t = t * (1.0 - alpha)
    bg_term = t * g_t

    sw, sda, dlo, dhi = (torch.zeros(shape + (k,)) for _ in range(4))
    ows, oda = torch.zeros(shape), torch.zeros(shape)
    dvol = torch.zeros(a.data.numel())
    zero = torch.zeros(())
    t = torch.ones(shape)
    pfx = torch.zeros(shape)
    for i in range(a.spr):
        rgba, s1, s2, w, vox = sample(i)
        inn = inside[..., i]
        rgba = torch.where(inn[..., None], rgba, rgba0)
        alpha = rgba[..., 3]
        gd = gdot(rgba)
        ws = t * alpha
        pfx = pfx + ws * gd
        suffix = total - pfx
        denom = 1.0 - alpha
        num = suffix + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, zero)
        t = t * denom
        ows = torch.where(inn, ows, ows + ws)
        oda = torch.where(inn, oda, oda + da)
        # the in-range samples' terms, as march_smooth_bwd_plain's
        ws_in = torch.where(inn, ws, zero)
        da_in = torch.where(inn, da, zero)
        dldw = ws_in[..., None] * gdk + da_in[..., None] * dk[:, 3]
        q = (dldw * sharp) * w
        dvn = torch.zeros(shape)
        wsum = torch.zeros(shape)
        for j in range(k - 1):
            dvn = dvn + q[..., j] * (s2[..., j] - s1[..., j])
            wsum = wsum + w[..., j]
        m = inn[..., None]
        dlo[..., 1:] = torch.where(m, dlo[..., 1:] - q * (1.0 - s1),
                                   dlo[..., 1:])
        dhi[..., 1:] = torch.where(m, dhi[..., 1:] + q * (1.0 - s2),
                                   dhi[..., 1:])
        sw[..., 1:] = torch.where(m, sw[..., 1:] + w * ws[..., None],
                                  sw[..., 1:])
        sda[..., 1:] = torch.where(m, sda[..., 1:] + w * da[..., None],
                                   sda[..., 1:])
        base = 1.0 - wsum
        sw[..., 0] = torch.where(inn, sw[..., 0] + base * ws, sw[..., 0])
        sda[..., 0] = torch.where(inn, sda[..., 0] + base * da, sda[..., 0])
        smooth_vjp.splat_volume_grad_plain(dvol, a.dims, vox,
                                           torch.where(inn, dvn, zero), cal)
    # the fold, once per ray
    dldw = ows[..., None] * gdk + oda[..., None] * dk[:, 3]
    q = (dldw * sharp) * w0
    dlo[..., 1:] = dlo[..., 1:] - q * (1.0 - s1_0)
    dhi[..., 1:] = dhi[..., 1:] + q * (1.0 - s2_0)
    sw[..., 1:] = sw[..., 1:] + w0 * ows[..., None]
    sda[..., 1:] = sda[..., 1:] + w0 * oda[..., None]
    wsum0 = torch.zeros(())
    for j in range(k - 1):
        wsum0 = wsum0 + w0[j]
    sw[..., 0] = sw[..., 0] + (1.0 - wsum0) * ows
    sda[..., 0] = sda[..., 0] + (1.0 - wsum0) * oda
    dcolors = torch.stack([gr[..., None] * sw, gg[..., None] * sw,
                           gb[..., None] * sw, sda], dim=-1).sum(dim=(0, 1))
    return (dcolors, dlo.sum(dim=(0, 1)), dhi.sum(dim=(0, 1)),
            dvol.reshape(a.dims))


BWD_CASES = {
    "odd_ortho_orbit": {},
    "odd_conic": {},
    "odd_camera_inside_conic": {},
    "odd_grazing_entry_faces": {},
    "odd_step_longer_than_a_voxel": {},
    "odd_front_clip": dict(tf=_tf16),
    "odd_all_rays_miss_ortho": {},
}


@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_regrouped_backward_matches_the_plain_backward(name):
    make_tf = BWD_CASES[name].get("tf")
    a = smooth_vjp.prepare_smooth_diff(
        *_scene(name, None if make_tf is None else make_tf()))
    rng = np.random.default_rng(13)
    scale = np.float32(1.0 / (a.width * a.height))
    g_rgb = torch.tensor(rng.normal(0.0, 1.0, (a.width, a.height, 3))
                         .astype(np.float32) * scale)
    g_t = torch.tensor(rng.normal(0.0, 1.0, (a.width, a.height))
                       .astype(np.float32) * scale)
    got = _range_bwd(a, g_rgb, g_t)
    want = smooth_vjp.march_smooth_bwd_plain(a, g_rgb, g_t, True)
    assert float(want[0].abs().max()) > 0.0
    for gname, x, y in zip(("dcolors", "dlower", "dupper"), got, want):
        torch.testing.assert_close(
            x, y, rtol=RTOL_BWD, atol=RTOL_BWD * float(y.abs().max()),
            msg=lambda m, gname=gname: f"{gname}: {m}")
    # an off-range sample has no corner in the volume: the same adds
    assert torch.equal(got[3], want[3])


def test_off_range_rgba_is_the_classify_of_zero_for_any_cal_max():
    """A sample off the volume reads +0, so its RGBA is classify(0 /
    cal_max), also for cal_max 0 (NaN) and below 0 (-0): the march stays
    bit-exact where the constant is the chain's own quotient."""
    for cal in (-3.0, 0.0):
        vol = dataclasses.replace(_odd(), cal_max=torch.tensor(cal))
        a = smooth.prepare_smooth(
            vol, P.default_transfer_function(device="cpu"),
            P.Camera.initial(position=NEAR, device="cpu"), SMALL, 0.0)
        got, want = _range_march(a), smooth.march_smooth_plain(a)
        assert torch.equal(got.isnan(), want.isnan())
        ok = ~want.isnan()
        assert torch.equal(got[ok], want[ok])
