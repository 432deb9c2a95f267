"""K6's fold of the constant samples (csrc/a5_bwd.cu) on each ray's span
(``ops/a5.sample_range``, test_torch_a5_range.py).

K6 runs the chain in coefficient form only on the samples of a ray's span;
every other sample is the constant c0 (the coefficients [id0 == k]).  Pass A
composites it in the full evaluation's operations (skipped where its alpha
a0 is 0); pass B sums its w, T and the numerator of dL/da and folds the sums
into interval id0 once a ray, with one division (a run of them at once where
a0 is 0, the length times one dL/da); the rgb columns are g times one sum of
coef w an interval.  A test-side mirror of that march, per ray, stays within
rtol 1e-5 of the float64 sums of ``march_a5_bwd_plain``'s terms, ray by ray
and in total, at TF(0).alpha 0 and 0.05, on orbits, a camera inside the
volume, a step longer than a voxel, rays that miss, the units of a (2, 2, 1)
mesh and rays stepped an ulp at a time across the box's faces; the rows of
``a5_vjp.block_sums`` are the kernel's 64x8 blocks.

chip_smoke.py holds the kernel's block partials to the same float64 sums on
the card (phase 3t); ``test_torch_a5_vjp.py`` holds the plain version against
the JAX package.  No JAX here."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.ops import a5, a5_vjp

from _torch_a5_scenes import FACE_CASES, SCENES, face_args, odd, tf, units

# the mirror against the float64 sums of the plain terms: regrouped float
# sums, of the largest component
RTOL_BWD = 1e-5


def _k6_mirror(a, g_rgb, g_t):
    """K6 over its spans, per ray, as a loop over samples vectorised over
    rays: the chain in coefficient form inside a ray's span; outside it
    the constant c0 (coefficients [id0 == k]), whose w, T and numerator are
    summed and folded into interval id0 once a ray, a run at once where
    a0 = 0; the rgb columns g times one sum of coef w an interval -> the
    per-ray sums [W * H, K, 4] in float32."""
    lo, hi = a5.sample_range(a)
    sample = a5_vjp._coef_samples(a)
    k = a.colors.shape[0]
    id0 = int(a.scal[a5.S_ID0])
    coef0 = (torch.arange(k) == id0).to(torch.float32)
    c0 = torch.zeros(4)
    for j in range(k):
        c0 = c0 + coef0[j] * a.colors[j]
    a0 = c0[3]
    a0_zero = float(a0) == 0.0
    gr, gg, gb = g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2]
    gd0 = (gr * c0[0] + gg * c0[1]) + gb * c0[2]
    denom0 = 1.0 - a0
    shape = (a.width, a.height)
    end = a.s_start + a.spr
    window = range(a.s_start, end)
    t = torch.ones(shape)
    total = torch.zeros(shape)
    for i in window:  # pass A
        span = (i >= lo) & (i <= hi)
        _, alpha, rgb = sample(i)
        gd = (gr * rgb[..., 0] + gg * rgb[..., 1]) + gb * rgb[..., 2]
        total = torch.where(span, total + (t * alpha) * gd, total)
        t = torch.where(span, t * (1.0 - alpha), t)
        if not a0_zero:
            total = torch.where(span, total, total + (t * a0) * gd0)
            t = torch.where(span, t, t * denom0)
    bg_term = t * g_t
    sw = torch.zeros(shape + (k,))
    sa = torch.zeros(shape + (k,))
    ow, oda, ot, onum = (torch.zeros(shape) for _ in range(4))
    t = torch.ones(shape)
    pfx = torch.zeros(shape)
    for i in window:  # pass B
        span = (i >= lo) & (i <= hi)
        coef, alpha, rgb = sample(i)
        gd = (gr * rgb[..., 0] + gg * rgb[..., 1]) + gb * rgb[..., 2]
        w = t * alpha
        pfx_f = pfx + w * gd
        denom = 1.0 - alpha
        num = (total - pfx_f) + bg_term
        da = t * gd - torch.where(denom != 0.0, num / denom, 0.0)
        sw = torch.where(span[..., None], sw + coef * w[..., None], sw)
        sa = torch.where(span[..., None], sa + coef * da[..., None], sa)
        t_f = t * denom
        if a0_zero:
            # the first sample of a run: [s_start, lo) or (hi, end)
            first = ~span & (((i == a.s_start) & (lo > a.s_start))
                             | (i == hi + 1))
            n = torch.where(i < lo, lo - a.s_start, end - 1 - hi).float()
            run = n * (t * gd0 - ((total - pfx) + bg_term))
            oda = torch.where(first, oda + run, oda)
            pfx = torch.where(span, pfx_f, pfx)
            t = torch.where(span, t_f, t)
            continue
        w0 = t * a0
        pfx0 = pfx + w0 * gd0
        ow = torch.where(span, ow, ow + w0)
        ot = torch.where(span, ot, ot + t)
        onum = torch.where(span, onum, onum + ((total - pfx0) + bg_term))
        pfx = torch.where(span, pfx_f, pfx0)
        t = torch.where(span, t_f, t * denom0)
    oda = oda + (gd0 * ot - (onum / denom0 if float(denom0) != 0.0
                             else 0.0))
    sw[..., id0] += ow
    sa[..., id0] += oda
    acc = torch.stack([gr[..., None] * sw, gg[..., None] * sw,
                       gb[..., None] * sw, sa], dim=-1)
    return acc.reshape(a.width * a.height, k, 4)


def _cotangents(a, seed=3):
    rng = np.random.default_rng(seed)
    g_rgb = rng.normal(0, 1, (a.width, a.height, 3)).astype(np.float32)
    g_t = rng.normal(0, 1, (a.width, a.height)).astype(np.float32)
    return torch.from_numpy(g_rgb), torch.from_numpy(g_t)


def _check_k6(a):
    g = _cotangents(a)
    got = _k6_mirror(a, *g).double()
    want = a5_vjp.march_a5_bwd_plain(a, *g, per_ray=True)
    scale = float(want.abs().max())
    assert scale > 0.0
    assert float((got - want).abs().max()) <= RTOL_BWD * scale
    total = want.sum(0)
    assert float((got.sum(0) - total).abs().max()) <= (
        RTOL_BWD * float(total.abs().max()))
    # the block partials' rows hold the rays of the kernel's 64x8 blocks
    rows = a5_vjp.block_sums(want, a.width, a.height)
    assert rows.shape[0] == a5_vjp.num_blocks(a.width, a.height)
    assert torch.allclose(rows.sum(0), total, rtol=0, atol=1e-12)


K6_CASES = ([(n, alpha0) for n in ("orbit", "inside", "coarse_step")
             for alpha0 in (0.0, 0.05)] + [("miss", 0.05)])


@pytest.mark.parametrize("name, alpha0", K6_CASES)
def test_k6_fold_within_rtol_of_plain(name, alpha0):
    a, _ = a5_vjp.prepare_a5_diff(
        odd(SCENES[name][1]), tf(alpha0),
        P.Camera.initial(position=SCENES[name][0], device="cpu"),
        SCENES[name][2])
    _check_k6(a)


@pytest.mark.parametrize("alpha0", [0.0, 0.05])
def test_k6_fold_on_units_and_faces(alpha0):
    pos, shape, cfg = SCENES["near"]
    for kw in units("near"):
        a, _ = a5_vjp.prepare_a5_diff(
            odd(shape), tf(alpha0),
            P.Camera.initial(position=pos, device="cpu"), cfg, **kw)
        _check_k6(a)
    for face, side, slope in FACE_CASES:
        _check_k6(face_args(face, side, slope, alpha0))
