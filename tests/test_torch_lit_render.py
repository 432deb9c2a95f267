"""Lit and LUT renders of the port against the JAX package: the plain scans
(a1 ortho and conic, a5) against ``render_vrc``/``render_test``, the fused
marches' plain versions (``march_plain``, ``march_a5_plain``: the CUDA
kernels' arithmetic) against the Pallas kernels in interpret mode, what
still raises, and the CLI's lit and ``--config`` renders.  The CUDA kernels
themselves are held against those plain versions on the card by
chip_smoke.py."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import pallas_a5 as jpa5
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import phong as jphong

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch.ops import a5, march, phong
from volumerenderingproject_tpu_torch.utils import imageio
from volumerenderingproject_tpu_torch.utils.config import Algorithm

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
TOL_SCAN = 2e-6  # port scan vs JAX scan (a5: ulps of the view inverse)
TOL_FUSED = 1e-5  # rgb * M + S is not phong_shade's order (JAX's own atol)


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


@pytest.fixture(scope="module")
def scene():
    """A small random volume with every default-TF interval, and a camera
    whose rays cross it and the empty space around it."""
    rng = np.random.default_rng(9)
    jv = J.make_volume(rng.uniform(-30, 255, (12, 14, 20)).astype(np.float32))
    return jv, J.default_transfer_function(), J.Camera.initial(
        position=(0.35, 0.45, 0.85))


@pytest.mark.parametrize("alg,kw", [
    (Algorithm.VRC, dict(lighting=True)),
    (Algorithm.VRC, dict(lighting=True, gradient_filter="sobel")),
    (Algorithm.VRC, dict(lighting=True, presmooth_sigma=1.0)),
    (Algorithm.VRC, dict(tf_lut=64)),
    (Algorithm.VRC, dict(tf_lut=256)),
    (Algorithm.VRC, dict(tf_lut=256, lighting=True, density_scale=0.6)),
    (Algorithm.VRC, dict(lighting=True, conic=True)),
    (Algorithm.TEST, dict(lighting=True)),
    (Algorithm.TEST, dict(lighting=True, gradient_filter="sobel",
                          presmooth_sigma=1.0)),
])
def test_scan_matches_jax(scene, alg, kw):
    """Front-to-back and back-to-front scans against the JAX scans."""
    jv, jtf, jc = scene
    cfg = J.RenderConfig(width=20, height=16, samples_per_ray=28,
                         algorithm=J.Algorithm[alg.name], **kw)
    jfn = jraycast.render_test if alg is Algorithm.TEST else jraycast.render_vrc
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    for jmode, pmode in (("fast", "scan"), ("reference", "reference")):
        want = np.asarray(jfn(jv, jtf, jc, cfg, mode=jmode))
        got = P.render(pv, ptf, pc, pcfg, mode=pmode, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCAN)
    fg = (np.abs(want[..., :3] - 0.2).max(-1) > 0.05).mean()
    assert fg > 0.05  # the rays do cross the volume


def test_explicit_light_matches_jax(scene):
    """An explicit light (non-uniform colour in the scan, uniform in the
    fused march) reaches both packages' shading."""
    jv, jtf, jc = scene
    cfg = J.RenderConfig(width=16, height=12, samples_per_ray=24)
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    for color in ([1.0, 0.6, 0.3], [0.8, 0.8, 0.8]):
        jl = jphong.Light(np.asarray([-0.2, 0.9, 0.4], np.float32),
                          np.asarray(color, np.float32), np.float32(0.3),
                          np.float32(0.6), np.float32(0.4), np.float32(9.0))
        pl = interop.light_from_numpy(
            *(np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS), device="cpu")
        want = np.asarray(jraycast.render_vrc(jv, jtf, jc, cfg, light=jl))
        got = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu",
                       light=pl).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCAN)
    fast = P.render(pv, ptf, pc, pcfg, device="cpu", light=pl).numpy()
    np.testing.assert_allclose(fast, got, rtol=0, atol=TOL_FUSED)


@pytest.mark.parametrize("kw", [dict(tf_lut=96), dict(lighting=True),
                                dict(lighting=True, tf_lut=256,
                                     gradient_filter="sobel")],
                         ids=["lut", "baked", "lut_baked"])
def test_march_plain_matches_pallas_interpret(kw):
    """K1's LUT, baked and LUT + baked variants: the plain version against
    the Pallas kernel in interpret mode (the scene of
    test_pallas_march.py), and against the port's scan."""
    rng = np.random.default_rng(9)
    jv = J.make_volume(rng.uniform(-30, 255, (12, 14, 100)).astype(np.float32))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=32, height=32, samples_per_ray=24, **kw)
    want = np.asarray(jpm.render_vrc_pallas(jv, jtf, jc, cfg, early_eps=0.0,
                                            interpret=True))
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    a = march.prepare(pv, ptf, pc, pcfg, 0.0)
    assert a.ids.dtype == (torch.uint16 if "tf_lut" in kw
                           else torch.uint8)
    assert (a.mgrid is not None) == ("lighting" in kw)
    got = march.march_plain(a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FUSED)
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu").numpy()
    np.testing.assert_allclose(got, scan, rtol=0, atol=TOL_FUSED)


def test_march_a5_plain_matches_pallas_interpret():
    """K3's baked variant: the plain version against the Pallas a5 kernel
    in interpret mode, and against the port's scan."""
    rng = np.random.default_rng(4)
    jv = J.make_volume(rng.uniform(-30, 255, (10, 12, 11)).astype(np.float32))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=20, height=14, samples_per_ray=40,
                         algorithm=J.Algorithm.TEST, lighting=True)
    want = np.asarray(jpa5.render_test_pallas(jv, jtf, jc, cfg, early_eps=0.0,
                                              interpret=True))
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    a = a5.prepare_a5(pv, ptf, pc, pcfg, 0.0)
    assert a.mgrid is not None and a.mgrid.shape == pv.dims
    got = a5.march_a5_plain(a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FUSED)
    scan = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu").numpy()
    np.testing.assert_allclose(got, scan, rtol=0, atol=TOL_FUSED)


def test_lit_early_termination_bound(scene):
    """eps = 1e-3 stays within 1.1e-3 of the exact lit LUT render."""
    jv, jtf, jc = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    cfg = P.RenderConfig(width=16, height=12, samples_per_ray=40,
                         lighting=True, tf_lut=256, density_scale=3.0)
    exact = march.march_plain(march.prepare(pv, ptf, pc, cfg, 0.0))
    early = march.march_plain(march.prepare(pv, ptf, pc, cfg, 1e-3))
    assert 0.0 < float((early - exact).abs().max()) <= 1.1e-3


@pytest.mark.parametrize("kw,exc,match", [
    (dict(lighting=True, conic=True), NotImplementedError, "item 9"),
    (dict(scattering=True), NotImplementedError, "item 9"),
    (dict(scattering=True, algorithm=Algorithm.TEST), NotImplementedError,
     "item 9"),
    (dict(tf_lut=2048), ValueError, "tf_lut"),
])
def test_fast_mode_limits_raise(kw, exc, match):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, **kw)
    with pytest.raises(exc, match=match):
        P.render(vol, P.default_transfer_function(device="cpu"),
                 P.Camera.initial(position=(0.9, 0.5, 1.0), device="cpu"),
                 cfg, device="cpu")


@pytest.mark.parametrize("alg", [Algorithm.VRC, Algorithm.TEST])
def test_non_uniform_light_colour_raises_in_fast_mode(alg):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, algorithm=alg)
    light = phong.default_light(device="cpu")
    light = phong.Light(light.direction,
                              torch.tensor([1.0, 0.5, 0.5]), light.ambient,
                              light.diffuse, light.specular, light.shininess)
    args = (vol, P.default_transfer_function(device="cpu"),
            P.reset_preset(device="cpu"), cfg)
    with pytest.raises(NotImplementedError, match="item 9"):
        P.render(*args, device="cpu", light=light)
    assert P.render(*args, mode="scan", device="cpu", light=light).shape == (
        8, 8, 4)


@pytest.mark.parametrize("kw", [dict(lighting=True), dict(tf_lut=256),
                                dict(lighting=True, algorithm=Algorithm.TEST)])
def test_lit_and_lut_fits_raise(kw):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, **kw)
    with pytest.raises(NotImplementedError, match="item 9"):
        pfit.fit_transfer_function(
            vol, P.reset_preset(device="cpu"), np.zeros((8, 8, 4), np.float32),
            P.default_transfer_function(device="cpu"), cfg, steps=1,
            device="cpu")


@pytest.mark.parametrize("argv,cfg_kw", [
    (["--lighting", "--gradient-filter", "sobel"],
     dict(lighting=True, gradient_filter="sobel")),
    (["--lighting", "--presmooth", "1.0", "--algorithm", "test"],
     dict(lighting=True, presmooth_sigma=1.0, algorithm=Algorithm.TEST)),
    (["--config", "{cfg}", "--lighting"], dict(tf_lut=256, lighting=True)),
], ids=["sobel", "a5_presmooth", "config_lut"])
def test_cli_lit_render_writes_the_rendered_png(tmp_path, argv, cfg_kw):
    cfg_path = os.path.join(tmp_path, "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(P.RenderConfig(tf_lut=256, width=99).to_json())
    out = os.path.join(tmp_path, "lit.png")
    argv = [a.format(cfg=cfg_path) for a in argv]
    assert cli.main(["render", "--data", "sphere", "--width", "26",
                     "--height", "20", "--spr", "40", "--device", "cpu",
                     "--out", out] + argv) == 0
    cfg = P.RenderConfig(width=26, height=20, samples_per_ray=40, **cfg_kw)
    img = P.render(synthetic.centered_sphere(device="cpu"),
                   P.default_transfer_function(device="cpu"),
                   P.reset_preset(device="cpu"), cfg, device="cpu")
    want = imageio.to_uint8(imageio.to_display(img, cfg.algorithm))[..., :3]
    got = np.asarray(Image.open(out).convert("RGB"))
    assert got.shape == (20, 26, 3)
    np.testing.assert_array_equal(got, want)
    assert json.loads(P.RenderConfig.from_json(open(cfg_path).read())
                      .to_json())["tf_lut"] == 256
