"""Port parity, the differentiable a5 march (ops/a5_vjp.py) and the a5 fit:
TF-colour gradients through the backward march's plain version on the CPU
against ``jax.grad`` of the JAX package's a5 scan
(``render_test(mode="fast")``) and against its Pallas a5 backward in
interpret mode (the alpha == 1 gate included), 3 a5 fit steps against the
JAX package's, and the CLI's ``--algorithm test``.  The CUDA kernel itself
(csrc/a5_bwd.cu) is held against ``march_a5_bwd_plain`` on the card by
chip_smoke.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.models.raycast import render as jrender_any
from volumerenderingproject_tpu.models.raycast import render_test as jrender
from volumerenderingproject_tpu.ops.pallas_a5 import render_test_pallas_diff

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch.ops import a5, a5_vjp
from volumerenderingproject_tpu_torch.scene.transfer_function import from_text
from volumerenderingproject_tpu_torch.utils import imageio
from volumerenderingproject_tpu_torch.utils.config import Algorithm

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
# against jax.grad of the scan: the backward sums a and rgb in coefficient
# form, the scan differentiates the mixed form (tests/test_pallas_a5.py:233)
RTOL_SCAN, ATOL_SCAN = 5e-3, 1e-4
RTOL_PALLAS = 1e-4  # against the Pallas backward: the same coefficient form
TOL = 2e-5


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_pallas_a5.py:189-235 (f32-row volume)."""
    rng = np.random.default_rng(31)
    jv = J.make_volume(rng.uniform(0.0, 255.0, (9, 11, 10)).astype(np.float32))
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30,
                         algorithm=J.Algorithm.TEST)
    target = rng.uniform(0.0, 1.0, (18, 13, 4)).astype(np.float32)
    return jv, jc, cfg, target


def _port_scene(jv, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, pc


def _port_tf(jtf):
    return interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")


def _with_colors(tf, colors, module):
    return module.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


def _tf_alpha(k, alpha):
    tf = J.default_transfer_function()
    return _with_colors(tf, tf.colors.at[k, 3].set(alpha), J)


def _tf16():
    """16 overlapping intervals with seeded bounds and colours (alphas up
    to 0.7, one of them 0)."""
    rng = np.random.default_rng(16)
    lo = np.sort(rng.uniform(0.0, 0.9, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.2, 16)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    colors[:, 3] *= np.float32(0.7)
    colors[5, 3] = 0.0
    return J.TransferFunction(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(colors), jnp.zeros(16, jnp.float32))


def _jax_grad(jv, jtf, jc, cfg, target, render):
    def loss(colors):
        img = render(jv, _with_colors(jtf, colors, J), jc, cfg)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    lx, gx = jax.value_and_grad(loss)(jtf.colors)
    return float(lx), np.asarray(gx)


def _port_grad(jv, jtf, jc, cfg, target):
    pv, pc = _port_scene(jv, jc)
    ptf = _port_tf(jtf)
    colors = ptf.colors.clone().requires_grad_()
    img = a5_vjp.render_test_diff(
        pv, _with_colors(ptf, colors, P), pc,
        P.RenderConfig.from_json(cfg.to_json()), device="cpu")
    loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3]) ** 2)
    loss.backward()
    return float(loss.detach()), colors.grad.numpy(), img.detach().numpy()


def _scan(jv, jtf, jc, cfg):
    return jrender(jv, jtf, jc, cfg, mode="fast")


@pytest.mark.parametrize("name,tf_fn", [
    ("default", J.default_transfer_function),
    ("alpha0_0.05", lambda: _tf_alpha(0, 0.05)),
    ("k16", _tf16),
])
def test_grads_match_jax_scan(scene, name, tf_fn):
    jv, jc, cfg, target = scene
    jtf = tf_fn()
    lx, gx = _jax_grad(jv, jtf, jc, cfg, target, _scan)
    lp, gp, img = _port_grad(jv, jtf, jc, cfg, target)
    np.testing.assert_allclose(img, np.asarray(_scan(jv, jtf, jc, cfg)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(lp, lx, rtol=1e-6)
    scale = np.abs(gx).max()
    assert scale > 0.0
    np.testing.assert_allclose(gp, gx, rtol=RTOL_SCAN, atol=ATOL_SCAN * scale)


@pytest.mark.parametrize("name,tf_fn,size", [
    ("default", J.default_transfer_function, (18, 13, 30)),
    # an interval of alpha exactly 1: the backward gates the (1 - a)
    # division to 0 where a sample's alpha is 1, as the Pallas kernel does
    ("alpha_one", lambda: _tf_alpha(3, 1.0), (16, 8, 20)),
])
def test_grads_match_pallas_backward(scene, name, tf_fn, size):
    jv, jc, cfg, target = scene
    w, h, spr = size
    cfg = cfg.replace(width=w, height=h, samples_per_ray=spr)
    target = target[:w, :h]
    jtf = tf_fn()

    def pallas(jv, jtf, jc, cfg):
        return render_test_pallas_diff(jv, jtf, jc, cfg, interpret=True)

    lx, gx = _jax_grad(jv, jtf, jc, cfg, target, pallas)
    lp, gp, _ = _port_grad(jv, jtf, jc, cfg, target)
    np.testing.assert_allclose(lp, lx, rtol=1e-6)
    np.testing.assert_allclose(gp, gx, rtol=RTOL_PALLAS,
                               atol=1e-6 * np.abs(gx).max())


def test_alpha_one_gate_is_hit():
    """Outside samples take TF(0)'s alpha, so TF(0).alpha == 1 puts a = 1
    exactly on every ray: the gate must give finite gradients equal to the
    plain re-derivation, dL/dalpha_0 = sum of T_0 (g . c_0) over rays."""
    vol = P.make_volume(np.zeros((4, 4, 4), np.float32), device="cpu")
    tf = P.default_transfer_function(device="cpu")
    colors = tf.colors.clone()
    colors[0] = torch.tensor([0.3, 0.5, 0.7, 1.0])
    cam = P.Camera.initial(position=(0.0, 0.0, 1.5), device="cpu")
    cfg = P.RenderConfig(width=6, height=5, samples_per_ray=8,
                         algorithm=Algorithm.TEST)
    a, _ = a5_vjp.prepare_a5_diff(vol, _with_colors(tf, colors, P), cam, cfg)
    rng = np.random.default_rng(0)
    g_rgb = torch.from_numpy(rng.normal(size=(6, 5, 3)).astype(np.float32))
    g_t = torch.from_numpy(rng.normal(size=(6, 5)).astype(np.float32))
    d = a5_vjp.march_a5_bwd_plain(a, g_rgb, g_t)
    assert torch.isfinite(d).all()
    # first sample: w = 1, every later sample has T = 0
    np.testing.assert_allclose(d[0, :3].numpy(), g_rgb.sum((0, 1)).numpy(),
                               rtol=1e-5)
    gd = (g_rgb * colors[0, :3]).sum(-1)
    np.testing.assert_allclose(float(d[0, 3]), float(gd.sum()), rtol=1e-5)
    assert torch.all(d[1:] == 0)


def test_fit_matches_jax(scene):
    """3 a5 fit steps from a perturbed TF, against the JAX package's fit
    (XLA a5 scan + optax.adam): losses rtol 1e-4, parameters atol 1e-5."""
    jv, jc, cfg, _ = scene
    jtf = J.default_transfer_function()
    target = np.asarray(_scan(jv, jtf, jc, cfg))
    colors = np.asarray(jtf.colors).copy()
    colors[1:, :3] -= np.float32(0.2)
    jparams, jlosses = jfit.fit_transfer_function(
        jv, jc, target, _with_colors(jtf, jnp.asarray(colors), J), cfg,
        steps=3, learning_rate=1e-2)
    pv, pc = _port_scene(jv, jc)
    ptf = interop.transfer_function_from_numpy(
        np.asarray(jtf.lower), np.asarray(jtf.upper), colors,
        np.asarray(jtf.hg_g), device="cpu")
    pparams, plosses = pfit.fit_transfer_function(
        pv, pc, target, ptf, P.RenderConfig.from_json(cfg.to_json()),
        steps=3, learning_rate=1e-2, device="cpu")
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(pparams.tf_colors.detach().numpy(),
                               np.asarray(jparams.tf_colors), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(pparams.density_scale.detach()),
                               float(jparams.density_scale), rtol=0,
                               atol=1e-5)
    assert abs(float(pparams.density_scale.detach()) - 1.0) > 1e-4


@pytest.mark.parametrize("kw,item", [
    (dict(lighting=True), "mode='scan'"),
    (dict(scattering=True), "mode='scan'"),
])
def test_unported_diff_options_raise(scene, kw, item):
    """Lit and scattered a5 fits raise in fast mode, naming the scan route,
    which fits them (tests/test_torch_scan_fit_a5_smooth.py)."""
    jv, jc, cfg, target = scene
    pv, pc = _port_scene(jv, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json()).replace(**kw)
    tf = P.default_transfer_function(device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        a5_vjp.render_test_diff(pv, tf, pc, pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        pfit.fit_transfer_function(pv, pc, target, tf, pcfg, steps=1,
                                   device="cpu", mode="fast")
    params, losses = pfit.fit_transfer_function(pv, pc, target, tf, pcfg,
                                                steps=1, device="cpu",
                                                mode="scan")
    assert np.isfinite(losses[0])
    assert not torch.equal(params.tf_colors, tf.colors)


def test_multichannel_and_more_than_16_intervals_raise(scene):
    jv, jc, cfg, _ = scene
    pv, pc = _port_scene(jv, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    k = 17
    tf17 = P.TransferFunction(torch.zeros(k), torch.ones(k),
                              torch.full((k, 4), 0.1), torch.zeros(k))
    tf = P.default_transfer_function(device="cpu")
    a5_vjp.check_diff_supported(pcfg, pv.channels, tf.num_intervals)
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        a5_vjp.render_test_diff(pv, tf17, pc, pcfg, device="cpu")
    # the forward a5 render takes up to 256 intervals
    assert P.render(pv, tf17, pc, pcfg, device="cpu").shape == (18, 13, 4)
    mc = interop.volume_from_numpy(np.zeros((4, 4, 4, 2), np.float32), 255.0,
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        a5_vjp.render_test_diff(mc, tf, pc, pcfg, device="cpu")
    # the scan route fits both
    for vol, tfx in ((pv, tf17), (mc, tf)):
        params = pfit.FitParams.init(tfx)
        loss = pfit.render_loss(params, tfx, vol, pc, torch.zeros(18, 13, 4),
                                pcfg, mode="scan")
        loss.backward()
        assert torch.isfinite(params.tf_colors.grad).all()


def test_bwd_kernel_wrapper_refuses_cpu_tensors(scene):
    """No fallback: the backward kernel's wrapper launches on CUDA or
    raises, and the CPU path of the autograd function launches nothing."""
    jv, jc, cfg, target = scene
    pv, pc = _port_scene(jv, jc)
    a, _ = a5_vjp.prepare_a5_diff(
        pv, P.default_transfer_function(device="cpu"), pc,
        P.RenderConfig.from_json(cfg.to_json()))
    g_rgb = torch.zeros((a.width, a.height, 3))
    before = (a5.launches, a5_vjp.launches)
    with pytest.raises(ValueError, match="CUDA"):
        a5_vjp.march_a5_bwd_kernel(a, g_rgb, g_rgb[..., 0].contiguous())
    _port_grad(jv, J.default_transfer_function(), jc, cfg, target)
    assert (a5.launches, a5_vjp.launches) == before


def test_cli_render_and_fit_algorithm_test(tmp_path):
    """``render`` and ``fit --algorithm test --device cpu``: the PNG is the
    a5 render (identity display orientation) and the fit writes the TF that
    ``fit_transfer_function`` gives on the same inputs."""
    size = ["--width", "20", "--height", "14", "--spr", "24"]
    png = os.path.join(tmp_path, "a5.png")
    assert cli.main(["render", "--data", "sphere", *size, "--algorithm",
                     "test", "--device", "cpu", "--out", png]) == 0
    cfg = P.RenderConfig(width=20, height=14, samples_per_ray=24,
                         algorithm=Algorithm.TEST)
    vol = synthetic.centered_sphere(device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.reset_preset(device="cpu")
    img = P.render(vol, tf, cam, cfg, device="cpu")
    want = imageio.to_uint8(imageio.to_display(img, Algorithm.TEST))[..., :3]
    np.testing.assert_array_equal(imageio.load_png(png),
                                  want.astype(np.float32) / 255.0)
    out = os.path.join(tmp_path, "fitted.txt")
    assert cli.main(["fit", "--data", "sphere", *size, "--algorithm", "test",
                     "--target", png, "--steps", "2", "--out-tf", out,
                     "--device", "cpu"]) == 0
    target = imageio.from_display(imageio.load_png(png), Algorithm.TEST)
    target = np.concatenate([target, np.ones_like(target[..., :1])], -1)
    params, _ = pfit.fit_transfer_function(vol, cam, target, tf, cfg,
                                           steps=2, device="cpu")
    with open(out) as f:
        fitted = from_text(f.read(), device="cpu")
    np.testing.assert_allclose(fitted.colors.numpy(),
                               params.tf_colors.detach().numpy(), rtol=1e-8)
    # the a0 point cloud renders (tests/test_torch_point.py): its PNG is
    # the JAX package's render of the same scene
    assert cli.main(["render", *size, "--algorithm", "point", "--device",
                     "cpu", "--out", png]) == 0
    jcfg = J.RenderConfig(width=20, height=14, samples_per_ray=24,
                          algorithm=J.Algorithm.POINT)
    jimg = np.asarray(jrender_any(jsynthetic.centered_sphere(),
                                  J.default_transfer_function(),
                                  J.reset_preset(), jcfg))
    want = imageio.to_uint8(imageio.to_display(jimg, Algorithm.POINT))
    np.testing.assert_array_equal(imageio.load_png(png),
                                  want[..., :3].astype(np.float32) / 255.0)
