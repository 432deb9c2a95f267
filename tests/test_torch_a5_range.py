"""Each ray's span of samples in the a5 marches (``ops/a5.sample_range``,
the mirror of ``a5_span`` in csrc/a5_common.cuh, in its float order).

K3 (csrc/a5.cu) and K6 (csrc/a5_bwd.cu) run the position and corner chain
only on the samples of a ray's span; every other sample is TF(0)'s colour
c0, the coefficients [id0 == k].  That is exact only if no sample whose
chain puts it inside [0, dims) lies outside the span.  These tests hold the
span to that where it is easiest to get wrong: odd dimensions, orbit
cameras, a camera inside the volume, fronts along an axis, rays that miss,
segment windows, a step longer than a voxel, a 512-deep volume, and rays
stepped an ulp at a time across each face of the box, crossing it at a
slope of 0.3, 1e-5, 1e-7 and 0 (parallel).  Then what the kernels build on
the spans:

- K3: samples outside the span skipped where c0's alpha is 0 and
  composited with c0 otherwise; a test-side mirror of that march is
  bit-exact to ``march_a5_plain`` at TF(0).alpha 0, 0.05 and -3e-5, eps 0
  and 1e-3, whole renders and segment units, unlit and baked;
- K6's fold of the constant samples: test_torch_a5_fold.py.

The kernels themselves are held against the plain versions on the card by
chip_smoke.py (phases 3c, 3d, 3q, 3r and 3t); ``test_torch_a5.py`` and
``test_torch_a5_vjp.py`` hold the plain versions against the JAX package.
Inputs are seeded with numpy, at small shapes; no JAX here."""

import pytest
import torch

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.ops import a5
from volumerenderingproject_tpu_torch.ops.sampling import (
    trilinear_mix_colors)

from _torch_a5_scenes import (FACE_CASES, FACES, SCENES, face_args, odd,
                              scene, tf, units)


def _inside_outside_span(a):
    """(samples inside [0, dims) outside the span, samples inside, samples
    in the spans) over every ray of ``a``; the hoisted chain is
    apply_stages here too."""
    lo, hi = a5.sample_range(a)
    q = a5.ray_q(a)
    dims = torch.tensor(a.dims, dtype=torch.float32)
    mats = a5._stage_rows(a)
    x = (torch.arange(a.width, dtype=torch.float32)
         + float(a.x_offset))[:, None].expand(a.width, a.height)
    y = torch.arange(a.height, dtype=torch.float32)[None, :].expand(
        a.width, a.height)
    lost = inside = 0
    for i in range(a.s_start, a.s_start + a.spr):
        p = a5.positions(a, q, i)
        assert torch.equal(p, a5.apply_stages(mats, x, y,
                                              torch.tensor(float(i))))
        ins = ((p >= 0.0) & (p < dims)).all(-1)
        lost += int((ins & ((i < lo) | (i > hi))).sum())
        inside += int(ins.sum())
    span = int((hi - lo + 1).clamp_min(0).sum())
    return lost, inside, span


@pytest.mark.parametrize("name", sorted(SCENES))
def test_no_inside_sample_outside_the_span(name):
    lost, inside, span = _inside_outside_span(scene(name))
    assert lost == 0
    assert (inside == 0) == (name == "miss")
    a = scene(name)
    total = a.width * a.height * a.spr
    assert inside <= span <= total
    if name == "miss":
        assert span == 0
    elif name not in ("inside", "coarse_step"):
        assert span < total  # the spans cut the march


@pytest.mark.parametrize("name", ["orbit", "inside", "near"])
def test_no_inside_sample_outside_a_unit_span(name):
    for kw in units(name):
        a = scene(name, **kw)
        lost, _, span = _inside_outside_span(a)
        assert lost == 0
        assert span <= a.width * a.height * a.spr
        lo, hi = a5.sample_range(a)
        end = a.s_start + a.spr
        empty = hi < lo
        assert ((lo >= a.s_start) & (hi <= end - 1)).all()
        assert ((lo[empty] == end) & (hi[empty] == end - 1)).all()


@pytest.mark.parametrize("face, side, slope", FACES)
def test_rays_stepped_an_ulp_across_a_face(face, side, slope):
    a = face_args(face, side, slope)
    lost, inside, span = _inside_outside_span(a)
    assert lost == 0
    assert 0 < inside < a.width * a.height * a.spr
    if slope == 0.3:  # a steep crossing: the span ends near it
        assert span < a.width * a.height * a.spr


def _k3_mirror(a):
    """K3's march over its spans, as a loop over samples vectorised over
    rays: the chain (march_a5_plain's, per sample) inside a ray's span, c0
    outside it, skipped where c0's alpha is 0 -> the image, or a unit's
    (C, T)."""
    lo, hi = a5.sample_range(a)
    corners = a5._corners(a)
    s = a.scal
    id0 = s[a5.S_ID0].to(torch.int64)
    c0 = a.colors[id0].clone()
    baked = a.mgrid is not None
    if baked:
        c0[:3] = c0[:3] * 1.0 + 0.0
        total = a.ids.numel()
        mflat, sflat = a.mgrid.reshape(-1), a.sgrid.reshape(-1)
    eps = s[a5.S_EPS].clamp_min(0.0)
    c = torch.zeros((a.width, a.height, 3))
    t = torch.ones((a.width, a.height, 1))
    for i in range(a.s_start, a.s_start + a.spr):
        active = (t.abs() > eps)[..., 0]
        span = (i >= lo) & (i <= hi)
        full = active & span
        mid, frac, inside, flat0 = corners(i)
        rgba = torch.where(inside[..., None],
                           trilinear_mix_colors(a.colors[mid], frac), c0)
        rgb = rgba[..., :3]
        if baked:
            f0 = flat0.clamp(0, total - 1)
            m = torch.where(inside, mflat[f0], 1.0)[..., None]
            sh = torch.where(inside, sflat[f0], 0.0)[..., None]
            rgb = torch.where(inside[..., None], rgb * m + sh, rgb)
        alpha = rgba[..., 3:4]
        cf, tf_ = c + (t * alpha) * rgb, t * (1.0 - alpha)
        c = torch.where(full[..., None], cf, c)
        t = torch.where(full[..., None], tf_, t)
        if float(c0[3]) != 0.0:  # the constant samples
            const = (active & ~span)[..., None]
            c = torch.where(const, c + (t * c0[3]) * c0[:3], c)
            t = torch.where(const, t * (1.0 - c0[3]), t)
    if a.segment:
        return c, t
    rgb = c + t * s[a5.S_BG:a5.S_BG + 3]
    return torch.cat([rgb, torch.ones_like(t)], dim=-1)


def _bits_equal(x, y):
    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


K3_CASES = ([("orbit", alpha0, eps) for alpha0 in (0.0, 0.05)
             for eps in (0.0, 1e-3)]
            + [(n, alpha0, eps) for n in ("inside", "coarse_step", "miss")
               for alpha0, eps in ((0.0, 0.0), (0.05, 1e-3))]
            + [("orbit", -3e-5, 0.0), ("near", 0.05, 1e-3)])


@pytest.mark.parametrize("name, alpha0, eps", K3_CASES)
def test_k3_span_march_is_bit_exact(name, alpha0, eps):
    a = scene(name, alpha0, eps)
    assert _bits_equal(_k3_mirror(a), a5.march_a5_plain(a))


@pytest.mark.parametrize("alpha0, eps", [(0.0, 0.0), (0.05, 1e-3)])
def test_k3_span_march_on_units_and_faces(alpha0, eps):
    for kw in units("near"):
        a = scene("near", alpha0, eps, **kw)
        for got, want in zip(_k3_mirror(a), a5.march_a5_plain(a)):
            assert _bits_equal(got, want)
    for face, side, slope in FACE_CASES:
        a = face_args(face, side, slope, alpha0, eps)
        assert _bits_equal(_k3_mirror(a), a5.march_a5_plain(a))


@pytest.mark.parametrize("alpha0", [0.0, 0.05])
def test_k3_span_march_baked(alpha0):
    pos, shape, cfg = SCENES["near"]
    a = a5.prepare_a5(odd(shape), tf(alpha0),
                      P.Camera.initial(position=pos, device="cpu"),
                      cfg.replace(lighting=True), 0.0)
    assert a.mgrid is not None
    assert _bits_equal(_k3_mirror(a), a5.march_a5_plain(a))
