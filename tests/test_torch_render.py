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
from volumerenderingproject_tpu_torch.diff import fit as pfit
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


UNPORTED = [
    (dict(scattering=True, conic=True), "item 9"),
    (dict(algorithm=Algorithm.POINT), None),
    (dict(lighting=True, conic=True, gradient_filter="sobel"), "mode='scan'"),
    (dict(scattering=True, conic=True, lighting=True), "item 9"),
    (dict(interp=Interp.TRILINEAR, tf_lut=256), "item 12"),
]


@pytest.mark.parametrize("kw,item", UNPORTED)
def test_unported_options_raise(kw, item):
    """Lit, LUT and scattered renders are ported
    (tests/test_torch_lit_render.py, tests/test_torch_scatter.py), and
    smooth renders (tests/test_torch_smooth.py), conic lighting with central
    differences (tests/test_torch_kernel_lighting.py); conic scattering,
    conic lighting with another gradient filter (the JAX kernel's rule) and
    a smooth LUT render in ``mode="fast"`` are not.  ``Algorithm.POINT``
    is ported (the a0 point cloud, tests/test_torch_point.py): it renders
    in every mode, equal to the JAX package's ``render``."""
    jv = jsynthetic.centered_sphere(8)
    jtf = J.default_transfer_function()
    jc = J.reset_preset()
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, **kw)
    jcfg = J.RenderConfig.from_json(cfg.to_json())
    pv, ptf, pc = _port(jv, jtf, jc)
    if item is None:
        got = P.render(pv, ptf, pc, cfg, mode="fast", device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jraycast.render(jv, jtf, jc, jcfg)))
        return
    with pytest.raises(NotImplementedError, match=item):
        P.render(pv, ptf, pc, cfg, mode="fast", device="cpu")


@pytest.mark.parametrize("kw", [kw for kw, item in UNPORTED if item])
def test_auto_route_takes_the_scan_for_former_raises(kw, caplog):
    """The default route (``mode="auto"``) renders and fits each config
    ``mode="fast"`` refuses through the scan, bit for bit, and logs it."""
    vol = psynthetic.centered_sphere(8, device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.reset_preset(device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, **kw)
    with caplog.at_level("INFO", logger="volumerenderingproject_tpu_torch"):
        got = P.render(vol, tf, cam, cfg, device="cpu")
    assert "mode='auto' takes the scan route" in caplog.text
    np.testing.assert_array_equal(
        got.numpy(), P.render(vol, tf, cam, cfg, mode="scan",
                              device="cpu").numpy())
    target = torch.full((8, 8, 4), 0.3)

    def fit(mode):
        params = pfit.FitParams.init(tf)
        loss = pfit.render_loss(params, tf, vol, cam, target, cfg, mode=mode)
        loss.backward()
        return [loss.detach(), params.tf_colors.grad,
                params.density_scale.grad]

    for a, b in zip(fit("auto"), fit("scan")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kw", [{}, dict(lighting=True), dict(tf_lut=64),
                                dict(interp=Interp.TRILINEAR),
                                dict(algorithm=Algorithm.TEST)])
def test_auto_route_takes_the_kernels_where_they_compute(kw, caplog):
    """Where a kernel renders (and differentiates) the config, the default
    route is ``mode="fast"`` bit for bit."""
    vol = psynthetic.centered_sphere(8, device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.reset_preset(device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=6, **kw)
    with caplog.at_level("INFO", logger="volumerenderingproject_tpu_torch"):
        got = P.render(vol, tf, cam, cfg, device="cpu")
    assert "mode='auto' takes the kernel route" in caplog.text
    np.testing.assert_array_equal(
        got.numpy(), P.render(vol, tf, cam, cfg, mode="fast",
                              device="cpu").numpy())
    target = torch.full((8, 8, 4), 0.3)

    def fit(mode):
        params = pfit.FitParams.init(tf)
        loss = pfit.render_loss(params, tf, vol, cam, target, cfg, mode=mode)
        loss.backward()
        return [loss.detach(), params.tf_colors.grad,
                params.density_scale.grad]

    assert pfit.diff_refusal(vol, tf, cfg) is None
    for a, b in zip(fit("auto"), fit("fast")):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_multichannel_raises():
    """4-D volumes render (tests/test_torch_multichannel.py), but not
    scattered (the JAX package's reason), nor lit in fast mode (the fused
    multichannel march is unlit, as the JAX kernel is)."""
    vol = interop.volume_from_numpy(np.zeros((4, 4, 4, 3), np.float32), 255.0,
                                    device="cpu")
    cfg = P.RenderConfig(width=4, height=4, samples_per_ray=4)
    args = (vol, P.default_transfer_function(device="cpu"),
            P.reset_preset(device="cpu"))
    assert P.render(*args, cfg, device="cpu").shape == (4, 4, 4)
    for mode in ("fast", "scan"):
        with pytest.raises(NotImplementedError,
                           match="supports single-channel volumes"):
            P.render(*args, cfg.replace(scattering=True), mode=mode,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        P.render(*args, cfg.replace(lighting=True), mode="fast",
                 device="cpu")


def test_render_keeps_image_layout():
    """[W, H, 4] with x = column: a wide image is wide in dim 0."""
    cfg = P.RenderConfig(width=20, height=8, samples_per_ray=10)
    img = P.render(psynthetic.centered_sphere(16, device="cpu"),
                   P.default_transfer_function(device="cpu"),
                   P.reset_preset(device="cpu"), cfg, device="cpu")
    assert tuple(img.shape) == (20, 8, 4)
    assert torch.all(img[..., 3] == 1.0)
