"""Smooth mode (``Interp.TRILINEAR``) of the port against the JAX package:
the trilinear intensity sampler (bit-equal), ``classify_smooth``, the
shared ray setup against the Pallas smooth kernel's ``_ray_setup``, the
smooth scans (ortho, conic, lit, reference order) against ``render_vrc``,
the fused march's plain version (``march_smooth_plain``: the CUDA kernel's
arithmetic) against the Pallas smooth forward in interpret mode, what fast
mode refuses, and the CLI's ``--interp``.  The kernel itself
(csrc/smooth.cu) is held against ``march_smooth_plain`` on the card by
chip_smoke.py.

Inputs are the JAX tests' size (tests/test_pallas_smooth.py:27-37: a
9x11x10 volume, 18x13 pixels, 30 samples per ray, sharpness 60), seeded
with numpy, with negative intensities and a float cal_max of 200.9 among
them: smooth mode divides by the float cal_max and clamps nothing."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models.raycast import render_vrc as jrender_vrc
from volumerenderingproject_tpu.ops import pallas_smooth as jps
from volumerenderingproject_tpu.ops import sampling as jsampling

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch.ops import march, sampling, smooth
from volumerenderingproject_tpu_torch.utils import imageio
from volumerenderingproject_tpu_torch.utils.config import Interp, RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
TOL_CLASSIFY = 1e-6  # sigmoid: XLA's exp and torch's differ by an ulp
TOL = 1e-5  # renders: those ulps through 30 samples of compositing


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


@pytest.fixture(scope="module")
def jax_test_scene():
    """tests/test_pallas_smooth.py:27-37 as it is, where the JAX package
    holds its interpret-mode Pallas smooth kernel to its scan at 1e-5."""
    rng = np.random.default_rng(7)
    jv = J.make_volume(rng.uniform(0.0, 255.0, size=(9, 11, 10))
                       .astype(np.float32))
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30,
                         interp=J.Interp.TRILINEAR, tf_sharpness=60.0)
    return jv, J.default_transfer_function(), jc, cfg


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_pallas_smooth.py:27-37 with intensities in
    [-40, 255) and cal_max 200.9."""
    rng = np.random.default_rng(7)
    jv = J.make_volume(rng.uniform(-40.0, 255.0, size=(9, 11, 10))
                       .astype(np.float32), cal_max=200.9)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30,
                         interp=J.Interp.TRILINEAR, tf_sharpness=60.0)
    return jv, J.default_transfer_function(), jc, cfg


def _tf16():
    """16 overlapping intervals with seeded bounds and colours."""
    rng = np.random.default_rng(16)
    lo = np.sort(rng.uniform(0.0, 0.9, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.2, 16)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    colors[:, 3] *= np.float32(0.7)
    return J.TransferFunction(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(colors), jnp.zeros(16, jnp.float32))


def test_trilinear_intensity_sample_bit_equal():
    """Inside, on integer positions, in the -1 band before the entry faces
    and beyond the far faces, on a volume with negative voxels, one channel
    and two."""
    rng = np.random.default_rng(3)
    vol = rng.uniform(-40.0, 255.0, (9, 11, 10)).astype(np.float32)
    pos = rng.uniform(-2.5, 12.5, (4000, 3)).astype(np.float32)
    pos[:300] = np.floor(pos[:300])
    band = rng.uniform(-1.0, 0.0, (300, 3)).astype(np.float32)
    pos[300:600] = np.where(rng.random((300, 3)) < 0.5, band,
                            pos[300:600])
    pos[600:900] = (np.asarray((9, 11, 10), np.float32)
                    - rng.uniform(0.0, 1.2, (300, 3)).astype(np.float32))
    for data in (vol, np.stack([vol, -0.5 * vol], axis=-1)):
        want = np.asarray(jsampling.trilinear_intensity_sample(
            jnp.asarray(data), jnp.asarray(pos)))
        got = sampling.trilinear_intensity_sample(torch.from_numpy(data),
                                                  torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sharpness", [40.0, 60.0, 200.0, 1000.0])
@pytest.mark.parametrize("which", ["default", "k16"])
def test_classify_smooth_matches_jax(sharpness, which):
    """Within an ulp of the sigmoid; at sharpness 1000 exp overflows to inf
    and the sigmoid comes out 0 in both packages."""
    jtf = J.default_transfer_function() if which == "default" else _tf16()
    _, ptf, _ = _port(J.make_volume(np.zeros((2, 2, 2), np.float32)), jtf,
                      J.Camera.initial())
    v = np.random.default_rng(int(sharpness)).uniform(
        -0.4, 1.4, 20000).astype(np.float32)
    want = np.asarray(jtf.classify_smooth(jnp.asarray(v), sharpness))
    got = ptf.classify_smooth(torch.from_numpy(v), sharpness).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_CLASSIFY)


@pytest.mark.parametrize("conic", [False, True])
def test_ray_setup_matches_pallas_smooth(scene, conic, monkeypatch):
    """The port's rays (``march._rays``, the float order of
    ``ray_setup`` in csrc/march_common.cuh, which K8 and K9 share) equal
    the rays of the Pallas smooth kernel's ``_ray_setup`` bit for bit, fed
    the same scalar vector, on every pixel of every 16x16 tile.  The port
    takes a correctly rounded 1/sqrt; ``lax.rsqrt`` on the CPU is not (an
    ulp off on about an eighth of its inputs), so for conic rays the
    Pallas setup runs here with the correctly rounded one: the test holds
    the float order, and the renders hold the rest to a tolerance."""
    jv, jtf, jc, cfg = scene
    if conic:
        monkeypatch.setattr(jps.jax.lax, "rsqrt", lambda x: jnp.asarray(
            (1.0 / np.sqrt(np.asarray(x, np.float64))).astype(np.float32)))
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json()).replace(conic=conic)
    a = smooth.prepare_smooth(pv, ptf, pc, pcfg, 0.0)
    o, d = march._rays(a)
    scal = a.scal.numpy()
    w, h = pcfg.width, pcfg.height
    tile = (16, 16, 16)
    got_o = np.full((w, h, 3), np.nan, np.float32)
    got_d = np.full((w, h, 3), np.nan, np.float32)
    for tx in range(-(-w // 16)):
        for ty in range(-(-h // 16)):
            ids = (tx, ty)
            monkeypatch.setattr(jps, "pl", types.SimpleNamespace(
                program_id=lambda i, ids=ids: ids[i]))
            jo, jd, s_idx, ok = jps._ray_setup(scal, conic, w, h, tile)
            e = np.arange(s_idx.size).reshape(s_idx.shape)
            f = e % 256
            px = tx * 16 + f // 16
            py = ty * 16 + f % 16
            sel = (np.asarray(s_idx) == 0) & np.asarray(ok)
            for c in range(3):
                got_o[px[sel], py[sel], c] = np.asarray(
                    jnp.broadcast_to(jo[c], s_idx.shape))[sel]
                got_d[px[sel], py[sel], c] = np.asarray(
                    jnp.broadcast_to(jd[c], s_idx.shape))[sel]
    np.testing.assert_array_equal(o.expand(w, h, 3).numpy(), got_o)
    np.testing.assert_array_equal(d.expand(w, h, 3).numpy(), got_d)


@pytest.mark.parametrize("kw", [
    dict(), dict(conic=True), dict(lighting=True),
    dict(lighting=True, conic=True, gradient_filter="sobel"),
    dict(density_scale=0.45, front_clip=0.3), dict(tf_lut=256)])
def test_smooth_scans_match_jax(scene, kw):
    """The port's smooth scan (front to back) and reference (back to front)
    against the JAX package's, ortho, conic and lit (the normal at the
    octree-NN voxel); ``tf_lut`` is not read in smooth mode."""
    jv, jtf, jc, cfg = scene
    cfg = cfg.replace(**kw)
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    for jmode, pmode in (("fast", "scan"), ("reference", "reference")):
        want = np.asarray(jrender_vrc(jv, jtf, jc, cfg, mode=jmode))
        got = P.render(pv, ptf, pc, pcfg, mode=pmode, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"{jmode} {kw}")
    fg = (np.abs(want[..., :3] - 0.2) > 0.05).mean()
    assert fg > 0.1, fg


def test_sharpness_1000_matches_unfused_jax(scene):
    """At sharpness 1000 the sigmoid's slope (up to 250 per unit of vn)
    magnifies an ulp of the sample chain: XLA's compiled scan, which fuses
    that chain, moves the JAX package's own render by 2e-5 from the same
    scan evaluated op by op (``jax.disable_jit``).  The port's scan and its
    fused march's plain version follow the op-by-op evaluation to 1e-6,
    with exp overflowing to inf and sigmoids of 0, not NaN."""
    jv, jtf, jc, cfg = scene
    cfg = cfg.replace(tf_sharpness=1000.0)
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    with jax.disable_jit():
        want = np.asarray(jrender_vrc(jv, jtf, jc, cfg, mode="fast"))
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu").numpy()
    fused = P.render(pv, ptf, pc, pcfg, device="cpu").numpy()
    assert np.isfinite(fused).all()
    np.testing.assert_allclose(scan, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fused, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sharpness", [200.0, 1000.0])
def test_conic_high_sharpness_on_jax_rays(scene, sharpness, monkeypatch):
    """ROADMAP F2: conic smooth renders at sharpness 200 and 1000, with
    both packages on JAX's rays (the port's correctly rounded 1/sqrt
    swapped for ``lax.rsqrt``, as the ray-setup test above swaps the
    other way): the port's scan and its fused march's plain version stay
    within 1e-5 of JAX's scan evaluated op by op, so the gap F2 measured
    is the rays' rsqrt and nothing else."""
    from volumerenderingproject_tpu_torch.utils import transforms

    monkeypatch.setattr(transforms, "rsqrt", lambda x: torch.from_numpy(
        np.asarray(jax.lax.rsqrt(jnp.asarray(x.numpy())))))
    jv, jtf, jc, cfg = scene
    cfg = cfg.replace(tf_sharpness=sharpness, conic=True)
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    with jax.disable_jit():
        want = np.asarray(jrender_vrc(jv, jtf, jc, cfg, mode="fast"))
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu").numpy()
    fused = P.render(pv, ptf, pc, pcfg, device="cpu").numpy()
    np.testing.assert_allclose(scan, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(fused, want, rtol=0, atol=TOL)


def test_march_smooth_plain_matches_pallas_and_scan(jax_test_scene):
    """The fused march's plain version at eps 0 against the Pallas smooth
    forward in interpret mode and against the port's scan; ``render()`` in
    fast mode on the CPU runs it.  On the JAX test's own scene: on the
    negative-voxel scene the interpret-mode kernel (its body compiled and
    fused by XLA) lies 1.07e-5 from the JAX package's own scan at one
    pixel, where the plain version lies 1.5e-6 from it
    (:func:`test_march_smooth_plain_matches_scan`)."""
    jv, jtf, jc, cfg = jax_test_scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    got = smooth.march_smooth_plain(smooth.prepare_smooth(pv, ptf, pc, pcfg,
                                                          0.0))
    want = np.asarray(jps.render_vrc_smooth_pallas(jv, jtf, jc, cfg,
                                                   interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    np.testing.assert_allclose(got.numpy(), scan.numpy(), rtol=0, atol=TOL)
    fast = P.render(pv, ptf, pc, pcfg, device="cpu")
    assert torch.equal(fast, got)


@pytest.mark.parametrize("conic", [False, True])
@pytest.mark.parametrize("which", ["default", "k16"])
def test_march_smooth_plain_matches_scan(scene, conic, which):
    """Ortho and conic, 4 and 16 intervals, at eps 0: within a few ulps of
    the scan (the classify adds its terms to c_0 one by one)."""
    jv, _, jc, cfg = scene
    jtf = J.default_transfer_function() if which == "default" else _tf16()
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json()).replace(conic=conic)
    got = smooth.march_smooth_plain(smooth.prepare_smooth(pv, ptf, pc, pcfg,
                                                          0.0))
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    np.testing.assert_allclose(got.numpy(), scan.numpy(), rtol=0, atol=TOL)
    want = np.asarray(jrender_vrc(jv, jtf, jc, cfg.replace(conic=conic),
                                  mode="fast"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_early_termination(scene):
    """At eps 1e-3 each ray stops before the first sample with T <= eps:
    within eps of the exact render, on fewer samples."""
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json()).replace(samples_per_ray=60)
    exact_stats, early_stats = {}, {}
    exact = smooth.march_smooth_plain(
        smooth.prepare_smooth(pv, ptf, pc, pcfg, 0.0), exact_stats)
    early = smooth.march_smooth_plain(
        smooth.prepare_smooth(pv, ptf, pc, pcfg, 1e-3), early_stats)
    assert float((early - exact).abs().max()) <= 1.1e-3
    assert early_stats["samples"] < exact_stats["samples"]
    assert exact_stats["samples"] == 18 * 13 * 60
    assert 0 < exact_stats["inside"] < exact_stats["samples"]
    fast = P.render(pv, ptf, pc, pcfg.replace(early_termination=1e-3),
                    device="cpu")
    assert torch.equal(fast, early)


@pytest.mark.parametrize("kw", [dict(lighting=True), dict(tf_lut=256),
                                dict(density_scale=0.45)])
def test_fast_mode_raises_what_the_kernel_lacks(scene, kw):
    """Lit, LUT and density-scaled smooth renders: fast mode raises naming
    item 12 (the JAX package's smooth kernel excludes them too), and
    ``mode="scan"`` renders them."""
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json()).replace(**kw)
    with pytest.raises(NotImplementedError, match="item 12"):
        P.render(pv, ptf, pc, pcfg, mode="fast", device="cpu")
    img = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    assert bool(torch.isfinite(img).all())


def test_more_than_16_intervals_raise_in_fast_mode(scene):
    jv, _, jc, cfg = scene
    k = 17
    jtf = J.TransferFunction(jnp.zeros(k), jnp.ones(k),
                             jnp.full((k, 4), 0.1), jnp.zeros(k))
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    with pytest.raises(NotImplementedError, match="item 12"):
        P.render(pv, ptf, pc, pcfg, mode="fast", device="cpu")
    assert bool(torch.isfinite(P.render(pv, ptf, pc, pcfg, mode="scan",
                                        device="cpu")).all())


def test_kernel_wrapper_refuses_cpu_tensors(scene):
    """No fallback: the kernel's wrapper launches on CUDA or raises, and
    the CPU path launches nothing."""
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    a = smooth.prepare_smooth(pv, ptf, pc, pcfg, 0.0)
    before = smooth.launches
    with pytest.raises(ValueError, match="CUDA"):
        smooth.march_smooth_kernel(a)
    P.render(pv, ptf, pc, pcfg, device="cpu")
    assert smooth.launches == before


def test_nearest_march_refuses_smooth_configs(scene):
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    with pytest.raises(ValueError, match="TRILINEAR"):
        march.prepare(pv, ptf, pc, RenderConfig.from_json(cfg.to_json()), 0.0)


def test_cli_render_trilinear(tmp_path):
    """``render --interp trilinear`` writes the PNG of the smooth render;
    ``--interp trilinear_color`` raises in fast mode, naming the scan,
    which renders it (``--mode scan``)."""
    out = str(tmp_path / "smooth.png")
    size = ["--width", "20", "--height", "14", "--spr", "24"]
    assert cli.main(["render", "--data", "sphere", *size, "--interp",
                     "trilinear", "--device", "cpu", "--out", out]) == 0
    cfg = RenderConfig(width=20, height=14, samples_per_ray=24,
                       interp=Interp.TRILINEAR)
    img = P.render(synthetic.centered_sphere(device="cpu"),
                   P.default_transfer_function(device="cpu"),
                   P.reset_preset(device="cpu"), cfg, device="cpu")
    want = imageio.to_uint8(imageio.to_display(img))[..., :3]
    np.testing.assert_array_equal(np.asarray(Image.open(out).convert("RGB")),
                                  want)
    nearest = P.render(synthetic.centered_sphere(device="cpu"),
                       P.default_transfer_function(device="cpu"),
                       P.reset_preset(device="cpu"),
                       cfg.replace(interp=Interp.NEAREST), device="cpu")
    assert not torch.equal(img, nearest)
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        cli.main(["render", *size, "--interp", "trilinear_color", "--device",
                  "cpu", "--mode", "fast", "--out", str(tmp_path / "x.png")])
    tc = str(tmp_path / "tc.png")
    assert cli.main(["render", *size, "--interp", "trilinear_color",
                     "--mode", "scan", "--device", "cpu", "--out", tc]) == 0
    want = P.render(synthetic.centered_sphere(device="cpu"),
                    P.default_transfer_function(device="cpu"),
                    P.reset_preset(device="cpu"),
                    cfg.replace(interp=Interp.TRILINEAR_COLOR), mode="scan",
                    device="cpu")
    np.testing.assert_array_equal(
        np.asarray(Image.open(tc).convert("RGB")),
        imageio.to_uint8(imageio.to_display(want))[..., :3])
