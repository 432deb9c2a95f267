"""K1's in-kernel lighting variant in the port against the JAX package:
Blinn-Phong on the central-difference normals of the raw volume, for conic
rays and for light colours that are not uniform.  The fused march's plain
version (``march_plain``: the CUDA lit variant's arithmetic, in the TPU
kernel's float order) against the Pallas kernel in interpret mode with
``lighting=True`` and against the JAX scan, with the interval TF and a LUT,
on a volume whose dense voxels touch every face (zero-padded neighbours);
the routing between the baked and in-kernel variants, what raises, and the
CLI's ``--conic``.  The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import phong as jphong

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch.ops import march, phong

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
TOL_FUSED = 1e-5  # march_plain vs the Pallas kernel in interpret mode
TOL_SCAN = 2e-5  # march_plain vs the JAX scan (phong_shade's float order)
CAMERA = J.Camera.initial(position=(0.35, 0.45, 0.85))


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _light(color):
    jl = jphong.Light(np.asarray([-0.2, 0.9, 0.4], np.float32),
                      np.asarray(color, np.float32), np.float32(0.3),
                      np.float32(0.6), np.float32(0.4), np.float32(9.0))
    pl = interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS), device="cpu")
    return jl, pl


@pytest.fixture(scope="module")
def volume():
    """The lit tests' random volume (tests/test_torch_lit_render.py)."""
    rng = np.random.default_rng(9)
    return J.make_volume(rng.uniform(-30, 255, (12, 14, 20))
                         .astype(np.float32))


def _faces_volume():
    """Dense voxels on every face (intensities in the bone and brain
    intervals), so the normals there read the zero padding."""
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 40, (9, 10, 11)).astype(np.float32)
    for ax in range(3):
        for end in (0, -1):
            idx = [slice(None)] * 3
            idx[ax] = end
            data[tuple(idx)] = rng.uniform(40, 120, data[tuple(idx)].shape)
    return J.make_volume(data)


@pytest.mark.parametrize("name,kw", [
    ("conic", dict(conic=True)),
    ("conic_lut64", dict(conic=True, tf_lut=64)),
    ("faces_conic_density", dict(conic=True, density_scale=1.7)),
])
def test_plain_matches_pallas_interpret_and_scan(volume, name, kw):
    """Conic lit renders (central filter, presmooth 0): the plain version
    of the lit variant against the Pallas kernel's in-kernel lighting in
    interpret mode and against the JAX scan."""
    jv = _faces_volume() if name.startswith("faces") else volume
    jtf = J.default_transfer_function()
    cfg = J.RenderConfig(width=20, height=16, samples_per_ray=28,
                         lighting=True, **kw)
    want = np.asarray(jpm.render_vrc_pallas(jv, jtf, CAMERA, cfg,
                                            early_eps=0.0, interpret=True))
    scan = np.asarray(jraycast.render_vrc(jv, jtf, CAMERA, cfg, mode="fast"))
    pv, ptf, pc = _port(jv, jtf, CAMERA)
    a = march.prepare(pv, ptf, pc, P.RenderConfig.from_json(cfg.to_json()),
                      0.0)
    assert march.variant(a) == ("lut_lit" if "tf_lut" in kw else "lit")
    got = march.march_plain(a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FUSED)
    np.testing.assert_allclose(got, scan, rtol=0, atol=TOL_SCAN)
    assert (np.abs(want[..., :3] - 0.2).max(-1) > 0.05).mean() > 0.3


def test_non_uniform_light_colour(volume):
    """An ortho render under the light colour (1.0, 0.8, 0.6): the
    in-kernel variant (the bake folds one colour) against the Pallas
    kernel in interpret mode, which routes it there too, and the scan."""
    jtf = J.default_transfer_function()
    cfg = J.RenderConfig(width=20, height=16, samples_per_ray=28,
                         lighting=True)
    jl, pl = _light([1.0, 0.8, 0.6])
    want = np.asarray(jpm.render_vrc_pallas(volume, jtf, CAMERA, cfg,
                                            early_eps=0.0, interpret=True,
                                            light=jl))
    scan = np.asarray(jraycast.render_vrc(volume, jtf, CAMERA, cfg,
                                          light=jl))
    pv, ptf, pc = _port(volume, jtf, CAMERA)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    a = march.prepare(pv, ptf, pc, pcfg, 0.0, light=pl)
    assert march.variant(a) == "lit"
    got = march.march_plain(a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FUSED)
    np.testing.assert_allclose(got, scan, rtol=0, atol=TOL_SCAN)
    fast = P.render(pv, ptf, pc, pcfg, device="cpu", light=pl).numpy()
    np.testing.assert_array_equal(fast, got)
    # the three channels shade apart
    assert np.abs(got[..., 0] - got[..., 2]).max() > 1e-3


def test_light_vector_and_interop():
    """The light [10] the kernel reads: the unit direction against JAX's
    ``direction / norm``, then colour and coefficients as given; interop
    carries a colour that is not uniform."""
    jl, pl = _light([1.0, 0.8, 0.6])
    np.testing.assert_array_equal(pl.color.numpy(), np.asarray(jl.color))
    vec = march.light_vector(pl).numpy()
    ldir = np.asarray(jl.direction / np.linalg.norm(jl.direction))
    np.testing.assert_allclose(vec[:3], ldir, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        vec[3:], np.concatenate([np.asarray(jl.color), np.asarray(
            [jl.ambient, jl.diffuse, jl.specular, jl.shininess], np.float32)]))


@pytest.mark.parametrize("kw,light_color,route", [
    (dict(), None, "baked"),
    (dict(conic=True), None, "lit"),
    (dict(conic=True, tf_lut=256), None, "lit"),
    (dict(), [1.0, 0.8, 0.6], "lit"),
    (dict(), [0.7, 0.7, 0.7], "baked"),
    (dict(scattering=True), None, "baked"),
])
def test_routing(kw, light_color, route):
    """Ortho under a uniform colour stays on the bake (exact on the card);
    conic rays and other colours take the in-kernel variant."""
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, lighting=True,
                         **kw)
    light = None if light_color is None else _light(light_color)[1]
    assert march.check_fused_supported(cfg, light) == route


@pytest.mark.parametrize("kw", [
    dict(conic=True, gradient_filter="sobel"),
    dict(conic=True, presmooth_sigma=1.0),
    dict(gradient_filter="sobel", light_color=True),
    dict(scattering=True, light_color=True),
])
def test_unsupported_lighting_raises(kw):
    """In-kernel lighting takes central differences at presmooth 0 only
    (the JAX kernel's rule, pallas_march.py:1463-1469), and fused
    scattering the bake's one colour; each raises naming the scan, which
    renders it."""
    kw = dict(kw)
    light = _light([1.0, 0.8, 0.6])[1] if kw.pop("light_color", False) \
        else None
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, lighting=True,
                         **kw)
    args = (vol, P.default_transfer_function(device="cpu"),
            P.Camera.initial(position=(0.9, 0.5, 1.0), device="cpu"), cfg)
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        P.render(*args, mode="fast", device="cpu", light=light)
    assert P.render(*args, mode="scan", device="cpu",
                    light=light).shape == (8, 8, 4)


def test_kernel_wrapper_refuses_cpu_tensors(volume):
    """No fallback: the wrapper launches the lit and mc variants on CUDA or
    raises, and the CPU render runs the plain version."""
    pv, ptf, pc = _port(volume, J.default_transfer_function(), CAMERA)
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, lighting=True,
                         conic=True)
    a = march.prepare(pv, ptf, pc, cfg, 0.0)
    mc = interop.volume_from_numpy(np.ones((4, 5, 6, 3), np.float32), 255.0,
                                   device="cpu")
    for args in (a, march.prepare(mc, ptf, pc, cfg.replace(lighting=False),
                                  0.0)):
        before = march.launches
        with pytest.raises(ValueError, match="CUDA"):
            march.march_kernel(args)
        assert march.launches == before


def test_cli_render_conic_lighting(tmp_path):
    out = str(tmp_path / "conic_lit.png")
    assert cli.main(["render", "--width", "16", "--height", "12", "--spr",
                     "24", "--conic", "--lighting", "--camera",
                     "0.9,0.5,1.0", "--device", "cpu", "--out", out]) == 0
    cfg = P.RenderConfig(width=16, height=12, samples_per_ray=24,
                         lighting=True, conic=True)
    assert cli._config(cli.build_parser().parse_args(
        ["render", "--conic", "--lighting", "--width", "16", "--height", "12",
         "--spr", "24"])) == cfg
