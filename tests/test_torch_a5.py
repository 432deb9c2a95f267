"""Port parity, the a5/TEST forward path: the glm helpers it needs
(``look_at``, ``inverse``), the stage matrices and sample positions, the
corner fetch and colour mix, the a5 id grid, the plain scan
(``render_test``) and the fused march's plain version (``ops/a5.py``)
against the JAX package on the CPU.  The CUDA kernel itself (csrc/a5.cu) is
held against ``march_a5_plain`` on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import sampling as jsampling
from volumerenderingproject_tpu.utils import transforms as JT

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.models import raycast as praycast
from volumerenderingproject_tpu_torch.ops import a5, sampling
from volumerenderingproject_tpu_torch.utils import transforms as PT
from volumerenderingproject_tpu_torch.utils.config import Algorithm, Interp

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
TOL = 2e-5  # fast renders (benchmarks/onchip_parity.py)
TOL_REFERENCE = 2e-6  # reference-order renders (DESIGN.md §5)
TOL_EPS = 1.1e-3  # eps = 1e-3 against the exact render
# float32 view matrices: glm's cofactor inverse and JAX's LU inverse (and
# the two dot orders in look_at) differ by a few ulps of entries ~2
TOL_MATRIX = 5e-7


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _pcfg(cfg):
    return P.RenderConfig.from_json(cfg.to_json())


def _zwrap_volume():
    """tests/test_pallas_a5.py:94-111: the z+1 tap of (2, 2, 5) wraps into
    (2, 3, 0)."""
    v = np.zeros((6, 6, 6), np.float32)
    v[2, 3, 0] = 150.0
    v[2, 2, 5] = 150.0
    return J.make_volume(v)


def _packed_wrap_volume():
    """tests/test_pallas_a5.py:157-175: a z-wrap and a y-wrap on z > 127."""
    v = np.zeros((6, 6, 130), np.float32)
    v[2, 3, 0] = 150.0
    v[2, 2, 129] = 150.0
    v[3, 0, 64] = 150.0
    v[2, 5, 64] = 150.0
    return J.make_volume(v)


def _random_volume():
    rng = np.random.default_rng(11)
    return J.make_volume(rng.uniform(0.0, 255.0, (10, 12, 11))
                         .astype(np.float32))


# name -> (volume, camera position, (width, height, samples per ray)): the
# scenes of tests/test_pallas_a5.py
SCENES = {
    "random": (_random_volume, (0.35, 0.45, 0.85), (20, 14, 40)),
    "sphere_nonsquare": (lambda: jsynthetic.centered_sphere(24),
                         (0.35, 0.45, 0.85), (33, 17, 25)),
    "z_wrap": (_zwrap_volume, (0.1, 0.2, 0.95), (16, 16, 24)),
    "packed_wraps": (_packed_wrap_volume, (0.1, 0.2, 0.95), (16, 16, 24)),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    vol_fn, pos, (w, h, spr) = SCENES[request.param]
    jv = vol_fn()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=pos)
    cfg = J.RenderConfig(width=w, height=h, samples_per_ray=spr,
                         algorithm=J.Algorithm.TEST)
    return jv, jtf, jc, cfg


@pytest.mark.parametrize("position", [(0.35, 0.45, 0.85), (1.5, 0.4, 0.0),
                                      (-0.7, 0.2, -1.3)])
def test_look_at_and_inverse_match_jax(position):
    jc = J.Camera.initial(position=position)
    _, _, pc = _port(J.make_volume(np.zeros((2, 2, 2), np.float32)),
                     J.default_transfer_function(), jc)
    jview = np.asarray(jc.look_at_origin_view())
    pview = pc.look_at_origin_view()
    np.testing.assert_allclose(pview.numpy(), jview, rtol=0, atol=TOL_MATRIX)
    # the inverse of the same matrix, glm's formula against JAX's LU
    pinv = PT.inverse(torch.from_numpy(jview.copy())).numpy()
    np.testing.assert_allclose(pinv, np.asarray(JT.inverse(jview)), rtol=0,
                               atol=TOL_MATRIX)
    # and of a general, well-conditioned matrix
    rng = np.random.default_rng(4)
    m = (rng.normal(size=(4, 4)) + 4.0 * np.eye(4)).astype(np.float32)
    np.testing.assert_allclose(PT.inverse(torch.from_numpy(m)).numpy(),
                               np.linalg.inv(m.astype(np.float64)),
                               rtol=1e-4, atol=1e-4)


def test_scale_and_scaling_exact():
    m = JT.translate(JT.identity(), (-1.0, -1.0, 0.0))
    v = (2.0 / 700, 2.0 / 700, -2.0 / 500)
    want = np.asarray(JT.scale(m, v))
    got = PT.scale(PT.translate(PT.identity(), (-1.0, -1.0, 0.0)), v)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(PT.scaling((3.0, 4.5, -2.0)).numpy(),
                                  np.asarray(JT.scaling((3.0, 4.5, -2.0))))


def test_a5_positions_match_jax(scene):
    """The stage matrices applied in the scan's order: exactly JAX's
    positions when given JAX's view inverse, and within a few ulps of the
    view matrices (times L) with the port's own."""
    jv, jtf, jc, cfg = scene
    pv, _, pc = _port(jv, jtf, jc)
    pcfg = _pcfg(cfg)
    x, y = jraycast.pixel_grid(cfg)
    px, py = praycast.pixel_grid(pcfg, "cpu")
    L = float(jv.longest_dimension)
    for i in (0, 7, cfg.samples_per_ray - 1):
        want = np.asarray(jraycast._a5_positions(x, y, jnp.float32(i), jc, jv,
                                                 cfg))
        ti = torch.tensor(float(i))
        got = praycast._a5_positions(px, py, ti, pc, pv, pcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * L)
        mc, _, tv = a5.stage_matrices(pc, pv.dims, pcfg)
        jiv = torch.from_numpy(np.asarray(
            JT.inverse(jc.look_at_origin_view())).copy())
        same = a5.apply_stages((mc, jiv, tv), px, py, ti).numpy()
        np.testing.assert_array_equal(same, want)


def test_to_volume_space_exact():
    jv = _random_volume()
    rng = np.random.default_rng(3)
    p = rng.uniform(-0.2, 1.2, (5, 7, 3)).astype(np.float32)
    pv, _, _ = _port(jv, J.default_transfer_function(),
                     J.Camera.initial())
    got = praycast._to_volume_space(torch.from_numpy(p), pv).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jraycast._to_volume_space(jnp.asarray(p), jv)))


@pytest.mark.parametrize("dims", [(6, 7, 5), (5, 4, 130)])
def test_corner_fetch_and_mix_exact(dims):
    """Corner intensities (float offsets, flat wraps, the flat < total
    guard), the y->x->z mix and the whole trilinear colour sample, on
    positions that reach every face of the volume."""
    rng = np.random.default_rng(dims[2])
    vol = rng.uniform(-30.0, 255.0, dims).astype(np.float32)
    pos = rng.uniform(-0.5, 1.0, (9, 11, 3)).astype(np.float32) * np.array(
        dims, np.float32)
    pos[0, :, 1] = dims[1] - 0.25  # y+1 taps wrap into the next x row
    pos[1, :, 2] = dims[2] - 1e-3  # z+1 taps wrap into the next y row
    pos[2, :, :] = np.array(dims, np.float32) - 0.5  # taps past the end
    jflat = jnp.asarray(vol.reshape(-1))
    pflat = torch.from_numpy(vol.reshape(-1))
    want = np.asarray(jsampling.corner_intensities(jflat, dims,
                                                   jnp.asarray(pos)))
    got = sampling.corner_intensities(pflat, dims, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    frac = rng.uniform(0, 1, (9, 11, 3)).astype(np.float32)
    c8 = rng.uniform(0, 1, (9, 11, 8, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        sampling.trilinear_mix_colors(torch.from_numpy(c8),
                                      torch.from_numpy(frac)).numpy(),
        np.asarray(jsampling.trilinear_mix_colors(jnp.asarray(c8),
                                                  jnp.asarray(frac))))
    jtf = J.default_transfer_function()
    _, ptf, _ = _port(J.make_volume(vol), jtf, J.Camera.initial())
    want = np.asarray(jsampling.trilinear_color_sample(
        jflat, dims, jnp.asarray(pos), jtf.classify, jnp.float32(200.9)))
    got = sampling.trilinear_color_sample(
        pflat, dims, torch.from_numpy(pos), ptf.classify,
        torch.tensor(200.9, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cal_max", [255.0, 200.9])
def test_a5_ids_exact(cal_max):
    """a5 value semantics: classify(v / float cal_max) with negatives kept,
    where the a1 grid divides by trunc(cal_max) and clamps negatives to 0;
    an interval below 0 tells the two apart."""
    rng = np.random.default_rng(5)
    vol = rng.uniform(-60.0, 255.0, (7, 9, 8)).astype(np.float32)
    vol[0, 0, :4] = (0.0, -0.0, 30.0, 200.9)
    jv = J.make_volume(vol, cal_max=cal_max)
    tf = J.default_transfer_function()
    jtf = J.TransferFunction(
        jnp.concatenate([tf.lower, jnp.asarray([-0.2], jnp.float32)]),
        jnp.concatenate([tf.upper, jnp.asarray([-0.05], jnp.float32)]),
        jnp.concatenate([tf.colors, jnp.ones((1, 4), jnp.float32)]),
        jnp.zeros(5, jnp.float32))
    pv, ptf, _ = _port(jv, jtf, J.Camera.initial())
    ids, id0 = a5.a5_ids(pv, ptf)
    want = np.asarray(jtf.classify_index(jv.data / jv.cal_max))
    assert ids.dtype == torch.uint8
    np.testing.assert_array_equal(ids.numpy(), want)
    assert int(id0) == int(jtf.classify_index(jnp.float32(0.0)))
    a1 = np.asarray(jtf.classify_index(jnp.maximum(jv.data, 0.0)
                                       / jnp.trunc(jv.cal_max)))
    assert (want == 4).any() and not (a1 == 4).any()


@pytest.mark.parametrize("mode,tol", [("fast", TOL),
                                      ("reference", TOL_REFERENCE)])
def test_render_test_matches_jax(scene, mode, tol):
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    want = np.asarray(jraycast.render_test(jv, jtf, jc, cfg, mode=mode))
    got = praycast.render_test(pv, ptf, pc, _pcfg(cfg), mode=mode).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_fused_plain_matches_jax_and_scan(scene):
    """``render`` (fused march, plain version on the CPU) at eps 0: within
    2e-5 of the JAX scan and bit-equal to the port's own scan."""
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = _pcfg(cfg)
    got = P.render(pv, ptf, pc, pcfg, device="cpu")
    want = np.asarray(jraycast.render(jv, jtf, jc, cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    assert torch.equal(got, scan)


def test_early_termination_bound_and_samples():
    """eps 1e-3 stops rays early and stays within 1.1e-3 of the exact
    render; ``stats`` counts the samples inside the volume on live rays."""
    jv = jsynthetic.centered_sphere(24)
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(1.5, 0.4, 0.0))
    cfg = J.RenderConfig(width=24, height=20, samples_per_ray=60,
                         algorithm=J.Algorithm.TEST)
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = _pcfg(cfg)
    exact_stats, early_stats = {}, {}
    exact = a5.march_a5_plain(a5.prepare_a5(pv, ptf, pc, pcfg, 0.0),
                              exact_stats)
    early = a5.march_a5_plain(a5.prepare_a5(pv, ptf, pc, pcfg, 1e-3),
                              early_stats)
    want = np.asarray(jraycast.render_test(jv, jtf, jc, cfg, mode="fast"))
    np.testing.assert_allclose(exact.numpy(), want, rtol=0, atol=TOL)
    assert float((early - exact).abs().max()) <= TOL_EPS
    assert 0 < early_stats["samples"] < exact_stats["samples"]
    # every sample inside the volume, on rays that never terminate at eps 0
    a = a5.prepare_a5(pv, ptf, pc, pcfg, 0.0)
    corners = a5._corners(a)
    inside = sum(int(corners(i)[2].sum()) for i in range(cfg.samples_per_ray))
    assert exact_stats["samples"] <= inside


@pytest.mark.parametrize("kw", [
    dict(conic=True), dict(interp=Interp.TRILINEAR), dict(density_scale=0.45),
    dict(tf_lut=64), dict(front_clip=0.5),
    dict(conic=True, conic_corrected=False),
    dict(empty_space_skipping=False)])
def test_a5_ignores_a1_options(kw):
    """Options the JAX a5 path never reads (raycast.py:534-587) leave the
    a5 render unchanged."""
    vol = P.make_volume(np.random.default_rng(2).uniform(
        0, 255, (8, 9, 7)).astype(np.float32), device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.Camera.initial(position=(0.35, 0.45, 0.85), device="cpu")
    cfg = P.RenderConfig(width=12, height=10, samples_per_ray=16,
                         algorithm=Algorithm.TEST)
    base = P.render(vol, tf, cam, cfg, device="cpu")
    assert torch.equal(P.render(vol, tf, cam, cfg.replace(**kw),
                                device="cpu"), base)


@pytest.mark.parametrize("kw", [dict(lighting=True, scattering=True),
                                dict(scattering=True)])
def test_scattered_a5_renders_in_every_mode(kw):
    """Scattered a5 renders are ported (tests/test_torch_scatter.py holds
    them to the JAX package): every mode renders, the fast one through the
    baked march, and the scattering adds light."""
    vol = P.make_volume(np.random.default_rng(2).uniform(
        0, 255, (8, 9, 7)).astype(np.float32), device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.Camera.initial(position=(0.35, 0.45, 0.85), device="cpu")
    cfg = P.RenderConfig(width=12, height=10, samples_per_ray=16,
                         algorithm=Algorithm.TEST, early_termination=0.0,
                         **kw)
    imgs = [P.render(vol, tf, cam, cfg, mode=mode, device="cpu")
            for mode in ("fast", "scan", "reference")]
    base = P.render(vol, tf, cam, cfg.replace(scattering=False), mode="scan",
                    device="cpu")
    for img in imgs:
        assert bool(torch.isfinite(img).all())
        assert float((img - imgs[1]).abs().max()) <= 2e-5
    assert float((imgs[1][..., :3] - base[..., :3]).min()) >= 0.0
    assert float((imgs[1] - base).abs().max()) > 1e-3


@pytest.mark.parametrize("kw,channels,item", [
    ({}, 3, "mode='scan'"),
])
def test_unported_a5_options_raise(kw, channels, item):
    """A 4-D a5 render: the fused a5 march raises, naming the scan, which
    renders it (as the JAX package's a5 kernel and scan do;
    tests/test_torch_multichannel.py holds the scan to JAX's)."""
    shape = (4, 4, 4) if channels == 1 else (4, 4, 4, channels)
    vol = interop.volume_from_numpy(np.zeros(shape, np.float32), 255.0,
                                    device="cpu")
    cfg = P.RenderConfig(width=4, height=4, samples_per_ray=4,
                         algorithm=Algorithm.TEST, **kw)
    args = (vol, P.default_transfer_function(device="cpu"),
            P.reset_preset(device="cpu"), cfg)
    with pytest.raises(NotImplementedError, match=item):
        P.render(*args, mode="fast", device="cpu")
    for mode in ("scan", "reference"):
        assert P.render(*args, mode=mode, device="cpu").shape == (4, 4, 4)


def test_scal_vector_layout():
    jv = _random_volume()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    pv, ptf, pc = _port(jv, J.default_transfer_function(), jc)
    cfg = P.RenderConfig(width=20, height=14, samples_per_ray=40,
                         algorithm=Algorithm.TEST, background=(0.1, 0.3, 0.5,
                                                               1.0))
    a = a5.prepare_a5(pv, ptf, pc, cfg, 1e-3)
    assert a.scal.shape == (a5.SCAL_LEN,) and a.scal.dtype == torch.float32
    mats = a5.stage_matrices(pc, pv.dims, cfg)
    for s, m in zip((a5.S_MC, a5.S_IV, a5.S_TV), mats):
        assert torch.equal(a.scal[s:s + 12], m[:3].reshape(-1))
    assert float(a.scal[a5.S_EPS]) == np.float32(1e-3)
    assert float(a.scal[a5.S_ID0]) == 0.0
    assert a.scal[a5.S_BG:a5.S_BG + 3].tolist() == [
        float(np.float32(v)) for v in (0.1, 0.3, 0.5)]
    assert (a.dims, a.width, a.height, a.spr) == ((10, 12, 11), 20, 14, 40)


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the kernel's wrapper launches on CUDA or raises, and
    the CPU render launches nothing."""
    jv = _random_volume()
    pv, ptf, pc = _port(jv, J.default_transfer_function(), J.Camera.initial())
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=8,
                         algorithm=Algorithm.TEST)
    a = a5.prepare_a5(pv, ptf, pc, cfg, 0.0)
    before = a5.launches
    with pytest.raises(ValueError, match="CUDA"):
        a5.march_a5_kernel(a)
    P.render(pv, ptf, pc, cfg, device="cpu")
    assert a5.launches == before
