"""The benchmark's reference against a tiny NumPy scan on the CPU, its
pieces against their definitions, and the counts it feeds the rooflines."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from gpubench import readers, scene
from gpubench.counts import kernels
from gpubench.reference import a1 as ref

DIMS = (9, 11, 7)
RENDER = dict(width=8, height=6, samples_per_ray=30, early_termination=0.0)


def _scene(lighting=False, seed=5):
    spec = dict(generator="shells", dims=list(DIMS), radii=[4.0, 5.0, 3.0],
                base=10.0, shells=[[1.0, 55.0], [0.8, 112.0], [0.45, 150.0]],
                noise_sigma=6.0)
    data = scene.volume(spec, seed, "cpu")
    tf = scene.transfer_function(dict(
        lower_255=[0, 30, 140, 105], upper_255=[255, 80, 160, 120],
        colors=[[0, 0, 0, 0], [241, 218, 202, 0.3], [124, 9, 42, 0.3],
                [223, 155, 141, 0.7]]), "cpu")
    return data, tf, ref.Scene.of(data, 255.0, tf["lower"], tf["upper"],
                                  lighting)


def _view(theta=0.7):
    return ref.View(*torch.tensor(scene.orbit_view(theta)).unbind(0))


def numpy_scan(data, tf, view, fr, eps):
    """A ray at a time, a sample at a time, in float32 NumPy."""
    f = np.float32
    d = data.numpy()
    dims = d.shape
    L = f(max(dims))
    n = f(2 ** ref.octree_depth(dims))
    lo = np.array([f(L / 2) - f(v / 2) for v in dims], f)
    hi = lo + np.array(dims, f)
    half = np.array([f(v / 2) for v in dims], f)
    tl, right, up, front = (getattr(view, k).numpy() for k in
                            ("top_left", "right", "up", "front"))
    cols = tf["colors"].numpy()
    lower, upper = tf["lower"].numpy(), tf["upper"].numpy()
    out = np.zeros((fr.width, fr.height, 3), f)
    needed = 0
    for x in range(fr.width):
        for y in range(fr.height):
            xs = (f(x) * f(fr.rsw)) / f(fr.width)
            ys = (f(y) * f(fr.rsh)) / f(fr.height)
            o = (tl + xs * right) + ys * (-up)
            c, t = np.zeros(3, f), f(1.0)
            for i in range(fr.spr):
                if not abs(t) > f(eps):
                    break
                ti = f(i) * f(fr.ds) + f(fr.clip)
                p = (o + ti * front) + f(0.5)
                res = (np.floor(p * n) / n) * L
                inside = bool(((p >= 0) & (p < 1) & (res >= lo)
                               & (res < hi)).all())
                v = f(0.0)
                if inside:
                    ijk = np.trunc((res + half) - f(L / 2)).astype(int)
                    v = max(d[tuple(ijk)], f(0.0))
                    needed += 1
                vn = v / f(255.0)
                k = 0
                for j in range(1, len(lower)):
                    if lower[j] <= vn <= upper[j]:
                        k = j
                a = cols[k, 3]
                c = c + (t * a) * cols[k, :3]
                t = t * (f(1.0) - a)
            out[x, y] = c + t * np.array([0.2, 0.2, 0.2], f)
    return out, needed


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_reference_matches_a_numpy_scan(eps):
    data, tf, sc = _scene()
    fr = ref.Frame.of(RENDER)
    view = _view()
    got, needed = ref.render(sc, fr, view, tf["colors"], None, eps)
    want, want_needed = numpy_scan(data, tf, view, fr, eps)
    assert needed == want_needed > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_sobel_matches_its_definition():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(5, 6, 4)).astype(np.float32)
    g = ref.sobel_gradient(torch.tensor(v)).numpy()
    p = np.pad(v.astype(np.float64), 1)
    d, s = np.array([-0.5, 0.0, 0.5]), np.array([0.25, 0.5, 0.25])
    for axis in range(3):
        want = np.zeros(v.shape)
        for a in range(3):
            for b in range(3):
                for c in range(3):
                    w = [s, s, s]
                    w[axis] = d
                    want += (w[0][a] * w[1][b] * w[2][c]
                             * p[a:a + 5, b:b + 6, c:c + 4])
        np.testing.assert_allclose(g[..., axis], want, atol=1e-6)


def test_phong_of_a_lit_voxel_and_an_unshaded_one():
    light = ref.Light(*(torch.tensor(v) for v in (
        [0.5, 1.0, 0.75], [1.0, 1.0, 1.0], 0.35, 0.55, 0.25, 16.0)))
    front = torch.tensor([0.0, 0.0, -1.0])
    rgb = torch.tensor([[0.5, 0.4, 0.3], [0.5, 0.4, 0.3]])
    nw = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
    got = ref.phong(rgb, nw, light, front)
    l = np.array([0.5, 1.0, 0.75]) / np.linalg.norm([0.5, 1.0, 0.75])
    h = l + np.array([0.0, 0.0, 1.0])
    h /= np.linalg.norm(h)
    want = (0.35 * rgb[0].numpy() + 0.55 * abs(l[2]) * rgb[0].numpy()
            + 0.25 * abs(h[2]) ** 16)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5)
    assert torch.equal(got[1], rgb[1])


def test_fit_gradient_matches_central_differences():
    data, tf, sc = _scene(lighting=True)
    fr = ref.Frame.of(dict(RENDER, lighting=True, gradient_filter="sobel"))
    view = _view(1.9)
    smp = ref.view_samples(sc, fr, view)
    target = torch.full((fr.width, fr.height, 4), 0.3)
    leaves = dict(tf_colors=tf["colors"].double().float(),
                  density_scale=torch.tensor(1.0),
                  **scene.light(dict(direction=[0.5, 1.0, 0.75],
                                     color=[1.0, 1.0, 1.0], ambient=0.7,
                                     diffuse=0.2, specular=0.25,
                                     shininess=16.0), "cpu"))
    leaves = {k: v.clone().requires_grad_() for k, v in leaves.items()}
    _, g = ref.loss_and_grad(sc, fr, view, smp, target, leaves)
    for name, idx in (("ambient", ()), ("tf_colors", (3, 3)),
                      ("direction", (1,))):
        h = 1e-2

        def loss_at(delta):
            vals = {k: v.detach().clone().requires_grad_() for k, v in
                    leaves.items()}
            with torch.no_grad():
                vals[name][idx] += delta
            return ref.loss_and_grad(sc, fr, view, smp, target, vals)[0]

        fd = (loss_at(h) - loss_at(-h)) / (2 * h)
        assert math.isclose(float(g[name][idx]), fd, rel_tol=2e-2,
                            abs_tol=1e-6), name


def test_k1_counts_follow_the_reference_samples():
    data, tf, sc = _scene()
    fr = ref.Frame.of(RENDER)
    _, needed = ref.render(sc, fr, _view(), tf["colors"], None, 1e-3)
    ops, nbytes = kernels.k1_work(needed, fr.width * fr.height, DIMS, 4,
                                  False)
    assert ops == needed * kernels.FLOPS_PER_SAMPLE
    assert nbytes == (min(math.prod(DIMS), needed) + 4 * 16
                      + fr.width * fr.height * 16)
    ops_b, nbytes_b = kernels.k1_work(needed, 1, DIMS, 4, True)
    assert ops_b == needed * (kernels.FLOPS_PER_SAMPLE
                              + kernels.FLOPS_PER_BAKED_SAMPLE)
    assert nbytes_b == min(math.prod(DIMS), needed) + 64 + 16 + min(
        8 * math.prod(DIMS), 8 * needed)


def test_k4_counts():
    ops, nbytes = kernels.k4_work(100, 300, 2, (4, 5, 6), 4, False, 0.0)
    assert ops == (100 * 40 + min(200, 4) * 4 + 2 * (4 * 8 + 1))
    ops_a, _ = kernels.k4_work(100, 300, 2, (4, 5, 6), 4, True, 0.5)
    assert ops_a == 100 * 47 + 200 * 11 + 2 * (4 * 8 + 1)
    assert nbytes == 100 + 2 * 16 + 2 * 4 * 16


def test_kernel_names_and_roofline_reader():
    assert kernels.kernel_of("void march_a1_kernel<true>(float const*)") == "K1"
    assert kernels.kernel_of("march_bwd_a1_kernel") == "K4"
    assert kernels.kernel_of("elementwise_kernel<128, 4>") is None
    record = dict(kernels=[("march_a1_kernel", 0.0, 2e-4),
                           ("foo", 2e-4, 3e-4),
                           ("march_a1_kernel", 1e-3, 1.2e-3)],
                  work={"K1": [(67e6, 0.0), None]})
    # 67e6 operations take 1e-6 s at the peak, of K1's 2e-4 s counted
    assert readers.roofline(record, "K1") == pytest.approx(0.5)
    assert readers.roofline(dict(record, work={"K1": [None]}), "K1") is None


def test_fit_gradient_is_the_same_in_blocks(monkeypatch):
    data, tf, sc = _scene()
    fr = ref.Frame.of(RENDER)
    view = _view(2.5)
    smp = ref.view_samples(sc, fr, view)
    target = torch.full((fr.width, fr.height, 4), 0.3)

    def run():
        leaves = dict(tf_colors=tf["colors"].clone().requires_grad_(),
                      density_scale=torch.tensor(1.1, requires_grad=True))
        return ref.loss_and_grad(sc, fr, view, smp, target, leaves)

    whole, g_whole = run()
    monkeypatch.setattr(ref, "SAMPLES_PER_BLOCK", fr.height * fr.spr * 3)
    parts, g_parts = run()
    assert parts == pytest.approx(whole, rel=1e-6)
    for k in g_whole:
        # sums in another order: float32 rounding of the largest component
        torch.testing.assert_close(g_parts[k], g_whole[k], rtol=1e-5,
                                   atol=1e-6 * float(g_whole[k].abs().max()))
