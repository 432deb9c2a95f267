"""Port parity where a TF alpha exceeds 1: a sample of alpha above 1 makes
the transmittance T negative, and the JAX package's XLA scan
(``render_vrc``/``render_test`` in fast mode) goes on compositing with it.
The fused marches' plain versions (the CUDA kernels' arithmetic) continue
while |T| > eps, so at eps 0 they march on too: the fast renders and the
differentiable renders of a1, smooth a1 and a5 against the JAX scan, on the
tests' 9x11x10 scene with the alphas of intervals 1-3 at 1.2.  The kernels
themselves are held against those plain versions on the card by
chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops.a5_vjp import render_test_diff
from volumerenderingproject_tpu_torch.ops.march_vjp import render_vrc_diff
from volumerenderingproject_tpu_torch.ops.smooth_vjp import (
    render_vrc_smooth_diff)
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
TOL = 2e-5  # values (benchmarks/onchip_parity.py)
GRAD_RTOL, GRAD_ATOL_SHARE = 5e-3, 1e-4  # a5 and smooth gradient parity

CASES = {
    "a1": (dict(), jraycast.render_vrc, render_vrc_diff),
    "smooth": (dict(interp=J.Interp.TRILINEAR, tf_sharpness=60.0),
               jraycast.render_vrc, render_vrc_smooth_diff),
    "a5": (dict(algorithm=J.Algorithm.TEST), jraycast.render_test,
           render_test_diff),
}


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_pallas_vjp.py:28-39 and the default TF with
    the alphas of intervals 1-3 at 1.2."""
    rng = np.random.default_rng(7)
    vol_np = rng.uniform(0.0, 255.0, size=(9, 11, 10)).astype(np.float32)
    jv = J.make_volume(vol_np)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30)
    target = rng.uniform(0.0, 1.0, size=(18, 13, 4)).astype(np.float32)
    jtf = J.default_transfer_function()
    colors = np.asarray(jtf.colors).copy()
    colors[1:, 3] = np.float32(1.2)
    jtf = dataclasses.replace(jtf, colors=jnp.asarray(colors))
    return jv, jtf, jc, cfg, target


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


@pytest.mark.parametrize("name", list(CASES))
def test_alpha_above_one_matches_jax_scan(scene, name):
    jv, jtf, jc, cfg0, target = scene
    kw, jrender, pdiff = CASES[name]
    cfg = cfg0.replace(**kw)
    pcfg = RenderConfig.from_json(cfg.to_json())
    pv, ptf, pc = _port(jv, jtf, jc)

    def jloss(colors):
        img = jrender(jv, dataclasses.replace(jtf, colors=colors), jc, cfg,
                      mode="fast")
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    want = np.asarray(jrender(jv, jtf, jc, cfg, mode="fast"))
    # the alphas above 1 drive T below 0 on some rays, so the march that
    # stops there would leave the scan
    assert want.shape == (18, 13, 4)
    fast = P.render(pv, ptf, pc, pcfg, device="cpu").numpy()
    np.testing.assert_allclose(fast, want, rtol=0, atol=TOL)

    lx, gx = jax.value_and_grad(jloss)(jtf.colors)
    gx = np.asarray(gx)
    colors = ptf.colors.clone().requires_grad_()
    img = pdiff(pv, P.TransferFunction(ptf.lower, ptf.upper, colors,
                                       ptf.hg_g), pc, pcfg, device="cpu")
    np.testing.assert_allclose(img.detach().numpy(), want, rtol=0, atol=TOL)
    loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3]) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lx), rtol=1e-5)
    np.testing.assert_allclose(colors.grad.numpy(), gx, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * np.abs(gx).max())


def test_some_rays_go_negative(scene):
    """The scene reaches T < 0: the scan's transmittance at the last sample
    is negative on some rays."""
    jv, jtf, jc, cfg, _ = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    black = P.TransferFunction(ptf.lower, ptf.upper,
                               torch.cat([torch.zeros(4, 3),
                                          ptf.colors[:, 3:]], 1), ptf.hg_g)
    # with black colours and a white background the image is T_N
    img = P.render(pv, black, pc, pcfg.replace(background=(1.0, 1.0, 1.0)),
                   mode="scan", device="cpu")
    assert float(img[..., 0].min()) < 0.0
