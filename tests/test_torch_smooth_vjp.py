"""The differentiable smooth march of the port (ops/smooth_vjp.py) against
the JAX package: colour, bound and volume gradients through
``_SmoothMarchFn`` with the plain versions of the kernels, against
``jax.grad`` of the JAX package's smooth scan and of its Pallas smooth
kernels in interpret mode (rtol 5e-3, atol 1e-4 of the largest: the JAX
test's tolerances, tests/test_pallas_smooth.py:62-76), the trilinear
adjoint against autograd, and the volume gradient computed only where it is
asked for.  The CUDA kernel itself (csrc/smooth_bwd.cu) is held against
``march_smooth_bwd_plain`` on the card by chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models.raycast import render_vrc as jrender_vrc
from volumerenderingproject_tpu.ops.pallas_smooth import (
    render_vrc_smooth_pallas,
)

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import (march_vjp, sampling, smooth,
                                                  smooth_vjp)
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
RTOL, ATOL_SHARE = 5e-3, 1e-4  # tests/test_pallas_smooth.py:72-74
NAMES = ("colors", "lower", "upper", "volume")


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _scene(low, cal_max):
    """tests/test_pallas_smooth.py:27-37's scene with intensities in
    [low, 255) and the given cal_max."""
    rng = np.random.default_rng(7)
    jv = J.make_volume(rng.uniform(low, 255.0, size=(9, 11, 10))
                       .astype(np.float32), cal_max=cal_max)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30,
                         interp=J.Interp.TRILINEAR, tf_sharpness=60.0)
    target = rng.uniform(0.0, 1.0, size=(18, 13, 4)).astype(np.float32)
    return jv, J.default_transfer_function(), jc, cfg, target


@pytest.fixture(scope="module")
def scene():
    """With negative intensities and cal_max 200.9."""
    return _scene(-40.0, 200.9)


@pytest.fixture(scope="module")
def jax_test_scene():
    """The JAX test's scene as it is."""
    return _scene(0.0, 255.0)


def _jax_grads(scene_, render):
    jv, jtf, jc, cfg, target = scene_

    def loss(colors, lower, upper, data):
        tf2 = dataclasses.replace(jtf, colors=colors, lower=lower,
                                  upper=upper)
        img = render(dataclasses.replace(jv, data=data), tf2, jc, cfg)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    lx, gx = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        jtf.colors, jtf.lower, jtf.upper, jv.data)
    return float(lx), [np.asarray(g) for g in gx]


def _port_grads(scene_, volume_grad=True):
    jv, jtf, jc, cfg, target = scene_
    pv, ptf, pc = _port(jv, jtf, jc)
    leaves = [t.clone().requires_grad_() for t in (ptf.colors, ptf.lower,
                                                   ptf.upper)]
    data = pv.data.clone().requires_grad_(volume_grad)
    tf2 = P.TransferFunction(leaves[1], leaves[2], leaves[0], ptf.hg_g)
    img = smooth_vjp.render_vrc_smooth_diff(
        dataclasses.replace(pv, data=data), tf2, pc,
        RenderConfig.from_json(cfg.to_json()), device="cpu")
    loss = torch.mean((img[..., :3] - torch.from_numpy(target[..., :3])) ** 2)
    loss.backward()
    grads = [leaves[0].grad, leaves[1].grad, leaves[2].grad, data.grad]
    return float(loss.detach()), img, [None if g is None else g.numpy()
                                       for g in grads]


def _assert_grads_close(got, want):
    for name, a, b in zip(NAMES, got, want):
        scale = np.abs(b).max()
        assert scale > 0.0, f"{name} gradient vacuous"
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=scale * ATOL_SHARE,
                                   err_msg=name)


@pytest.mark.parametrize("conic", [False, True])
def test_grads_match_jax_scan(scene, conic):
    """Colours, bounds and volume against ``jax.grad`` of the JAX smooth
    scan, ortho and conic (the port's splat takes the forward's positions;
    trap: JAX's Pallas splat recomputes conic directions by a norm)."""
    sc = scene[:3] + (scene[3].replace(conic=conic),) + scene[4:]
    lx, gx = _jax_grads(sc, lambda v, t, c, f: jrender_vrc(v, t, c, f,
                                                          mode="fast"))
    lp, _, gp = _port_grads(sc)
    np.testing.assert_allclose(lp, lx, rtol=1e-5)
    _assert_grads_close(gp, gx)
    assert np.abs(gp[1][0]) == 0.0 and np.abs(gp[2][0]) == 0.0


def test_grads_match_pallas_backward(jax_test_scene):
    """Against ``jax.grad`` through the Pallas smooth kernels in interpret
    mode (forward at eps 0, backward, the XLA splat)."""
    lx, gx = _jax_grads(jax_test_scene, lambda v, t, c, f:
                        render_vrc_smooth_pallas(v, t, c, f, interpret=True,
                                                 early_eps=0.0))
    lp, _, gp = _port_grads(jax_test_scene)
    np.testing.assert_allclose(lp, lx, rtol=1e-5)
    _assert_grads_close(gp, gx)


def test_volume_gradient_only_where_asked(scene, monkeypatch):
    """With ``volume.data`` not requiring grad the backward computes no
    volume gradient (JAX's ``volume_grad=False``); the TF gradients are the
    same bits either way, and the image is the fast render at eps 0."""
    asked = []
    backward = smooth_vjp._backward

    def spy(a, g_rgb, g_t, volume_grad):
        asked.append(volume_grad)
        return backward(a, g_rgb, g_t, volume_grad)

    monkeypatch.setattr(smooth_vjp, "_backward", spy)
    _, img, with_vol = _port_grads(scene, volume_grad=True)
    _, _, without = _port_grads(scene, volume_grad=False)
    assert asked == [True, False]
    assert without[3] is None and with_vol[3] is not None
    for a, b in zip(with_vol[:3], without[:3]):
        np.testing.assert_array_equal(a, b)
    jv, jtf, jc, cfg, _ = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    fast = P.render(pv, ptf, pc, RenderConfig.from_json(cfg.to_json()),
                    device="cpu")
    assert torch.equal(img.detach(), fast)


def test_splat_is_the_trilinear_adjoint():
    """``splat_volume_grad_plain`` equals autograd through
    ``trilinear_intensity_sample`` of the same positions, corners out of
    range included."""
    rng = np.random.default_rng(11)
    dims = (6, 7, 5)
    vol = torch.from_numpy(rng.uniform(-1, 1, dims).astype(np.float32))
    vox = torch.from_numpy(rng.uniform(-1.5, 7.5, (40, 30, 3))
                           .astype(np.float32))
    dvn = torch.from_numpy(rng.normal(0, 1, (40, 30)).astype(np.float32))
    cal = torch.tensor(200.9)
    v = vol.clone().requires_grad_()
    (torch.sum(dvn * (sampling.trilinear_intensity_sample(v, vox) / cal))
     ).backward()
    got = torch.zeros(vol.numel())
    smooth_vjp.splat_volume_grad_plain(got, dims, vox, dvn, cal)
    np.testing.assert_allclose(got.reshape(dims).numpy(), v.grad.numpy(),
                               rtol=1e-5, atol=1e-7)


def test_alpha_one_gate_and_k16(scene):
    """Samples of alpha exactly 1 (1 - a == 0 gates the division term, as
    pallas_smooth.py:412-416 does) and 16 intervals: finite gradients of the
    right shapes."""
    jv, _, jc, cfg, target = scene
    colors = np.random.default_rng(1).uniform(0, 1, (16, 4)).astype(np.float32)
    colors[:, 3] = 1.0
    lo = np.linspace(0.0, 0.9, 16).astype(np.float32)
    jtf = J.TransferFunction(jnp.asarray(lo), jnp.asarray(lo + 0.1),
                             jnp.asarray(colors), jnp.zeros(16, jnp.float32))
    _, img, grads = _port_grads((jv, jtf, jc, cfg, target))
    assert bool(torch.isfinite(img).all())
    for g, shape in zip(grads, ((16, 4), (16,), (16,), jv.dims)):
        assert g.shape == shape and np.isfinite(g).all()


def test_unsupported_configs_raise(scene):
    """What the smooth kernels lack raises naming item 12; the nearest-voxel
    differentiable march refuses smooth configs."""
    jv, jtf, jc, cfg, _ = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    for kw in (dict(lighting=True), dict(tf_lut=256),
               dict(density_scale=0.5)):
        with pytest.raises(NotImplementedError, match="item 12"):
            smooth_vjp.render_vrc_smooth_diff(pv, ptf, pc, pcfg.replace(**kw),
                                              device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        march_vjp.render_vrc_diff(pv, ptf, pc, pcfg, device="cpu")


def test_bwd_kernel_wrapper_refuses_cpu_tensors(scene):
    """No fallback: K9's wrapper launches on CUDA or raises, and the CPU
    path of the autograd function launches nothing."""
    jv, jtf, jc, cfg, _ = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    a = smooth_vjp.prepare_smooth_diff(pv, ptf, pc,
                                       RenderConfig.from_json(cfg.to_json()))
    g_rgb = torch.zeros((a.width, a.height, 3))
    before = (smooth.launches, smooth_vjp.launches)
    with pytest.raises(ValueError, match="CUDA"):
        smooth_vjp.march_smooth_bwd_kernel(a, g_rgb,
                                           g_rgb[..., 0].contiguous())
    _port_grads(scene, volume_grad=False)
    assert (smooth.launches, smooth_vjp.launches) == before
