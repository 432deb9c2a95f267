"""Port parity, the whole slice: ``render`` of the port on the CPU against
the JAX package's ``render`` (its XLA scan on the CPU), the reference-order
scan, and the committed sphere golden."""

import os

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.utils import imageio as jimageio

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ingest import synthetic as psynthetic
from volumerenderingproject_tpu_torch.utils import imageio as pimageio
from volumerenderingproject_tpu_torch.utils.config import Algorithm, Interp

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "goldens")
TOL = 2e-5  # fused-path renders (benchmarks/onchip_parity.py)
TOL_REFERENCE = 2e-6  # reference-mode renders (DESIGN.md §5)


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors", "hg_g")),
        device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _alpha0_tf():
    """The default table with TF(0).alpha > 0: every skip must turn off."""
    tf = J.default_transfer_function()
    colors = np.asarray(tf.colors).copy()
    colors[0, 3] = 0.05
    return J.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(9)
    return J.make_volume(rng.uniform(-30, 255, (12, 14, 100)).astype(np.float32))


@pytest.mark.parametrize("name,tf_fn,cfg_kw", [
    ("ortho", J.default_transfer_function, {}),
    ("conic", J.default_transfer_function, dict(conic=True)),
    ("alpha0", _alpha0_tf, {}),
    ("density_scale", J.default_transfer_function, dict(density_scale=0.45)),
])
def test_render_matches_jax_render(volume, name, tf_fn, cfg_kw):
    jtf = tf_fn()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=32, height=32, samples_per_ray=24, **cfg_kw)
    want = np.asarray(jraycast.render(volume, jtf, jc, cfg))
    pv, ptf, pc = _port(volume, jtf, jc)
    got = P.render(pv, ptf, pc, P.RenderConfig.from_json(cfg.to_json()),
                   device="cpu")
    assert got.device.type == "cpu" and tuple(got.shape) == (32, 32, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["scan", "reference"])
def test_scan_modes_match_jax_render_vrc(volume, mode):
    jtf = J.default_transfer_function()
    jc = J.reset_preset()
    cfg = J.RenderConfig(width=24, height=20, samples_per_ray=30)
    want = np.asarray(jraycast.render_vrc(
        volume, jtf, jc, cfg, mode="fast" if mode == "scan" else mode))
    pv, ptf, pc = _port(volume, jtf, jc)
    got = P.render(pv, ptf, pc, P.RenderConfig.from_json(cfg.to_json()),
                   mode=mode, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_REFERENCE)


def test_segment_mode_matches_jax(volume):
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=16, height=12, samples_per_ray=20)
    jc_seg, jt_seg = jraycast.render_vrc(volume, jtf, jc, cfg, mode="segment")
    pv, ptf, pc = _port(volume, jtf, jc)
    c_seg, t_seg = P.render_vrc(pv, ptf, pc,
                                P.RenderConfig.from_json(cfg.to_json()),
                                mode="segment")
    np.testing.assert_allclose(c_seg.numpy(), np.asarray(jc_seg), rtol=0,
                               atol=TOL_REFERENCE)
    np.testing.assert_allclose(t_seg.numpy(), np.asarray(jt_seg), rtol=0,
                               atol=TOL_REFERENCE)


def test_sphere_golden():
    """goldens/sphere_100x100_a1_spr100.png within 1.5/255
    (tests/test_regression_goldens.py:27-31, 94-107)."""
    cfg = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    img = P.render(psynthetic.centered_sphere(device="cpu"),
                   P.default_transfer_function(device="cpu"),
                   P.reset_preset(device="cpu"), cfg, mode="reference",
                   device="cpu")
    golden = jimageio.load_png(os.path.join(GOLDEN_DIR,
                                            "sphere_100x100_a1_spr100.png"))
    ours = pimageio.to_uint8(pimageio.to_display(img[..., :3])) / 255.0
    assert np.abs(ours - golden).max() <= 1.5 / 255.0


def test_fused_sphere_matches_jax_fast():
    """The fused march's plain version on the sphere, against the JAX scan."""
    cfg = J.RenderConfig(width=40, height=36, samples_per_ray=60,
                         early_termination=0.0)
    jv = jsynthetic.centered_sphere(40)
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(1.5, 0.4, 0.0))
    want = np.asarray(jraycast.render_vrc(jv, jtf, jc, cfg, mode="fast"))
    pv, ptf, pc = _port(jv, jtf, jc)
    got = P.render(pv, ptf, pc, P.RenderConfig.from_json(cfg.to_json()),
                   device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("kw,item", [
    (dict(algorithm=Algorithm.TEST, scattering=True), "item 9"),
    (dict(algorithm=Algorithm.POINT), "item 15"),
    (dict(lighting=True, conic=True), "item 9"),
    (dict(scattering=True), "item 9"),
    (dict(interp=Interp.TRILINEAR), "item 12"),
])
def test_unported_options_raise(kw, item):
    """Lit and LUT renders are ported (tests/test_torch_lit_render.py);
    scattering and conic lighting in fast mode are not."""
    vol = psynthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, **kw)
    with pytest.raises(NotImplementedError, match=item):
        P.render(vol, P.default_transfer_function(device="cpu"),
                 P.reset_preset(device="cpu"), cfg, device="cpu")


def test_multichannel_raises():
    vol = interop.volume_from_numpy(np.zeros((4, 4, 4, 3), np.float32), 255.0,
                                    device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        P.render(vol, P.default_transfer_function(device="cpu"),
                 P.reset_preset(device="cpu"),
                 P.RenderConfig(width=4, height=4, samples_per_ray=4),
                 device="cpu")


def test_render_keeps_image_layout():
    """[W, H, 4] with x = column: a wide image is wide in dim 0."""
    cfg = P.RenderConfig(width=20, height=8, samples_per_ray=10)
    img = P.render(psynthetic.centered_sphere(16, device="cpu"),
                   P.default_transfer_function(device="cpu"),
                   P.reset_preset(device="cpu"), cfg, device="cpu")
    assert tuple(img.shape) == (20, 8, 4)
    assert torch.all(img[..., 3] == 1.0)
