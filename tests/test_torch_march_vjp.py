"""Port parity, the differentiable march (ops/march_vjp.py): the render's
value and its TF-colour and density gradients through the backward march's
plain version on the CPU, against ``jax.value_and_grad`` of the JAX
package's XLA scan (``render_vrc(mode="fast")``), and the alpha == 1 gate
against the JAX Pallas backward in interpret mode.  The CUDA kernel itself
(csrc/march_bwd.cu) is held against ``march_bwd_plain`` on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models.raycast import render_vrc as jrender_vrc
from volumerenderingproject_tpu.ops.pallas_march_vjp import (
    render_vrc_pallas_diff,
)

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import march, march_vjp
from volumerenderingproject_tpu_torch.utils.config import Interp, RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
RTOL, ATOL = 1e-4, 1e-6  # dcolors (tests/test_pallas_vjp.py:71-72)
TOL = 2e-5  # values (benchmarks/onchip_parity.py)


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_pallas_vjp.py:28-39."""
    rng = np.random.default_rng(7)
    vol_np = rng.uniform(0.0, 255.0, size=(9, 11, 10)).astype(np.float32)
    jv = J.make_volume(vol_np)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30)
    target = rng.uniform(0.0, 1.0, size=(18, 13, 4)).astype(np.float32)
    return jv, jc, cfg, target


def _port_tf(jtf):
    return interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")


def _port_scene(jv, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, pc


def _with_colors(tf, colors, module):
    return module.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


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


def _jax_loss_and_grad(jv, jtf, jc, cfg, target, render):
    def loss(colors):
        img = render(jv, _with_colors(jtf, colors, J), jc, cfg)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    lx, gx = jax.value_and_grad(loss)(jtf.colors)
    return float(lx), np.asarray(gx)


def _port_loss_and_grad(jv, jtf, jc, cfg, target):
    pv, pc = _port_scene(jv, jc)
    ptf = _port_tf(jtf)
    colors = ptf.colors.clone().requires_grad_()
    img = march_vjp.render_vrc_diff(
        pv, _with_colors(ptf, colors, P), pc,
        RenderConfig.from_json(cfg.to_json()), device="cpu")
    loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3]) ** 2)
    loss.backward()
    return float(loss.detach()), colors.grad.numpy(), img.detach().numpy()


def _scan(jv, jtf, jc, cfg):
    return jrender_vrc(jv, jtf, jc, cfg, mode="fast")


@pytest.mark.parametrize("name,tf_fn,cfg_kw", [
    ("ortho", J.default_transfer_function, {}),
    ("conic", J.default_transfer_function, dict(conic=True)),
    ("k16", _tf16, {}),
    ("density_0.45", J.default_transfer_function, dict(density_scale=0.45)),
])
def test_grads_match_jax_scan(scene, name, tf_fn, cfg_kw):
    jv, jc, cfg, target = scene
    cfg = cfg.replace(**cfg_kw)
    jtf = tf_fn()
    lx, gx = _jax_loss_and_grad(jv, jtf, jc, cfg, target, _scan)
    lp, gp, img = _port_loss_and_grad(jv, jtf, jc, cfg, target)
    np.testing.assert_allclose(img, np.asarray(_scan(jv, jtf, jc, cfg)),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(lp, lx, rtol=1e-6)
    np.testing.assert_allclose(gp, gx, rtol=RTOL, atol=ATOL)
    assert np.abs(gp).max() > 0.0  # a gradient that is not all zero


def test_density_grad_matches_jax_scan(scene):
    """d loss / d density through the alpha-column fold
    (tests/test_pallas_vjp.py:76-94)."""
    jv, jc, cfg, target = scene
    jtf = J.default_transfer_function()

    def jloss(density):
        colors = jtf.colors.at[:, 3].mul(density)
        img = _scan(jv, _with_colors(jtf, colors, J), jc, cfg)
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    gx = float(jax.grad(jloss)(jnp.asarray(1.3, jnp.float32)))
    pv, pc = _port_scene(jv, jc)
    ptf = _port_tf(jtf)
    density = torch.tensor(1.3, requires_grad=True)
    colors = torch.cat([ptf.colors[:, :3], ptf.colors[:, 3:4] * density], 1)
    img = march_vjp.render_vrc_diff(
        pv, _with_colors(ptf, colors, P), pc,
        RenderConfig.from_json(cfg.to_json()), device="cpu")
    torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3]) ** 2
               ).backward()
    np.testing.assert_allclose(float(density.grad), gx, rtol=1e-4)
    assert abs(gx) > 0.0


def test_alpha_one_gate_matches_pallas_backward(scene):
    """An interval of alpha exactly 1: the backward gates the (1 - a)
    division to 0 as the TPU kernel does (pallas_march_vjp.py:437), run
    here in interpret mode; the scan's true limit differs there."""
    jv, jc, cfg, target = scene
    cfg = cfg.replace(width=16, height=8, samples_per_ray=20)
    target = target[:16, :8]
    tf = J.default_transfer_function()
    jtf = _with_colors(tf, tf.colors.at[3, 3].set(1.0), J)

    def pallas(jv, jtf, jc, cfg):
        return render_vrc_pallas_diff(jv, jtf, jc, cfg, interpret=True)

    lx, gx = _jax_loss_and_grad(jv, jtf, jc, cfg, target, pallas)
    lp, gp, _ = _port_loss_and_grad(jv, jtf, jc, cfg, target)
    np.testing.assert_allclose(lp, lx, rtol=1e-6)
    np.testing.assert_allclose(gp, gx, rtol=RTOL, atol=ATOL)
    _, gscan = _jax_loss_and_grad(jv, jtf, jc, cfg, target, _scan)
    assert np.abs(gscan - gx).max() > 1e-3  # the gate is what differs


def test_negative_alpha_repair(scene):
    """TF(0).alpha < 0 (a fit's first Adam step can put it there): every
    sample of that alpha counts, so prep marches every sample, the brick map
    marks each brick holding such a voxel, and the fused render equals the
    JAX package's exact scan."""
    jv, jc, cfg, _ = scene
    tf = J.default_transfer_function()
    jtf = _with_colors(tf, tf.colors.at[0, 3].set(-3e-5), J)
    pv, pc = _port_scene(jv, jc)
    ptf = _port_tf(jtf)
    pcfg = RenderConfig.from_json(cfg.to_json())
    a = march.prepare(pv, ptf, pc, pcfg, 0.0)
    assert float(a.scal[march.S_FULL]) == 1.0
    nz = (ptf.colors[:, 3] != 0)[a.ids.long()]  # voxels of alpha != 0
    assert bool((a.ids == 0).any())  # voxels of the negative alpha
    want_occ = [bool(nz[x:x + 8, y:y + 8, z:z + 8].any())
                for x in range(0, 9, 8) for y in range(0, 11, 8)
                for z in range(0, 10, 8)]
    np.testing.assert_array_equal(a.occ.numpy(), want_occ)
    got = P.render(pv, ptf, pc, pcfg, device="cpu").numpy()
    want = np.asarray(_scan(jv, jtf, jc, cfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the negative alpha moves the image by more than the tolerance
    assert np.abs(want - np.asarray(_scan(jv, tf, jc, cfg))).max() > TOL


def test_negative_alpha_marks_only_its_bricks():
    """A negative alpha inside the volume marks exactly the bricks of its
    voxels (alpha != 0), like a positive one."""
    ids = torch.zeros((16, 9, 8), dtype=torch.uint8)
    ids[9, 2, 3] = 1
    tf = P.TransferFunction(torch.tensor([0.0, 0.5]), torch.tensor([1.0, 0.6]),
                            torch.tensor([[0.0] * 4, [1.0, 1.0, 1.0, -1e-6]]),
                            torch.zeros(2))
    occ, nb = march.brick_occupancy(ids, tf.colors)
    assert nb == (2, 2, 1)
    np.testing.assert_array_equal(occ.numpy(), [0, 0, 1, 0])


@pytest.mark.parametrize("cfg_kw,item", [
    (dict(lighting=True), "item 9"),
    (dict(scattering=True), "item 9"),
    (dict(tf_lut=256), "item 9"),
    (dict(interp=Interp.TRILINEAR), "item 12"),
])
def test_unported_options_raise(scene, cfg_kw, item):
    jv, jc, cfg, _ = scene
    pv, pc = _port_scene(jv, jc)
    pcfg = RenderConfig.from_json(cfg.to_json()).replace(**cfg_kw)
    tf = P.default_transfer_function(device="cpu")
    assert not march_vjp.diff_eligible(pv, tf, pcfg)
    with pytest.raises(NotImplementedError, match=item):
        march_vjp.render_vrc_diff(pv, tf, pc, pcfg, device="cpu")


def test_more_than_16_intervals_raise(scene):
    jv, jc, cfg, _ = scene
    pv, pc = _port_scene(jv, jc)
    k = 17
    tf = P.TransferFunction(torch.zeros(k), torch.ones(k),
                            torch.full((k, 4), 0.1), torch.zeros(k))
    pcfg = RenderConfig.from_json(cfg.to_json())
    assert march_vjp.diff_eligible(pv, P.default_transfer_function(
        device="cpu"), pcfg)
    assert not march_vjp.diff_eligible(pv, tf, pcfg)
    with pytest.raises(NotImplementedError, match="item 11"):
        march_vjp.render_vrc_diff(pv, tf, pc, pcfg, device="cpu")


def test_bwd_kernel_wrapper_refuses_cpu_tensors(scene):
    """No fallback: the backward kernel's wrapper launches on CUDA or
    raises, and the CPU path of the autograd function launches nothing."""
    jv, jc, cfg, target = scene
    pv, pc = _port_scene(jv, jc)
    a, _ = march_vjp.prepare_diff(pv, P.default_transfer_function(device="cpu"),
                                  pc, RenderConfig.from_json(cfg.to_json()))
    g_rgb = torch.zeros((a.width, a.height, 3))
    before = (march.launches, march_vjp.launches)
    with pytest.raises(ValueError, match="CUDA"):
        march_vjp.march_bwd_kernel(a, g_rgb, g_rgb[..., 0].contiguous())
    _port_loss_and_grad(jv, J.default_transfer_function(), jc, cfg, target)
    assert (march.launches, march_vjp.launches) == before
