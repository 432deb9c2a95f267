"""Volumes beyond the TPU's resident budget, a1 backward: the JAX package
fits them with its streamed backward kernel (K5:
``render_vrc_pallas_diff_streamed``, K4 over the ownership extents of
x-blocks staged from HBM, the edge blocks owning the samples off the
volume).  On the H100 the volume stays in device memory and K4 marches it
whole, so the port's K4 path (its plain version here, through
``render_vrc_diff``) is held to the streamed kernel in interpret mode at
the JAX tests' small multi-block sizes (``block_x=8``;
tests/test_pallas_vjp.py): values within 1e-5, colour gradients within
rtol 1e-4 / atol 1e-6, in both visit directions and with TF(0).alpha > 0,
so that samples off the volume carry gradients.  chip_smoke.py holds K4
to the same plain version at 320^3 and 512^3 on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ops import pallas_march_vjp as jpvjp

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import march_vjp
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL = 1e-5  # values, the streamed kernels' atol against the scan


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _with_alpha0(jtf, alpha0):
    return J.TransferFunction(jtf.lower, jtf.upper,
                              jtf.colors.at[0, 3].set(alpha0), jtf.hg_g)


def _jax_value_and_grad(render, jtf, target):
    def loss(colors):
        img = render(J.TransferFunction(jtf.lower, jtf.upper, colors,
                                        jtf.hg_g))
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2), img

    (_, img), g = jax.value_and_grad(loss, has_aux=True)(jtf.colors)
    return np.asarray(img), np.asarray(g)


def _port_value_and_grad(diff, jv, jtf, jc, cfg, target):
    pv, ptf, pc = _port(jv, jtf, jc)
    colors = ptf.colors.clone().requires_grad_()
    img = diff(pv, P.TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g),
               pc, RenderConfig.from_json(cfg.to_json()), device="cpu")
    loss = torch.mean((img[..., :3] - torch.tensor(target[..., :3])) ** 2)
    loss.backward()
    return img.detach().numpy(), colors.grad.numpy()


@pytest.mark.parametrize("pos,alpha0", [((0.4, 0.3, 0.9), 0.0),
                                        ((-0.6, 0.2, 0.7), 0.1)])
def test_k4_matches_streamed_backward(pos, alpha0):
    """test_streamed_diff_matches_xla and test_streamed_diff_alpha0_outside_
    samples: both visit directions, the second with TF(0).alpha 0.1."""
    rng = np.random.default_rng(11)
    jv = J.make_volume(rng.uniform(0.0, 255.0, (24, 10, 9)).astype(np.float32))
    cfg = J.RenderConfig(width=16, height=6, samples_per_ray=32)
    target = rng.uniform(0.0, 1.0, (16, 6, 4)).astype(np.float32)
    jtf = _with_alpha0(J.default_transfer_function(), alpha0)
    jc = J.Camera.initial(position=pos)
    want_img, want_g = _jax_value_and_grad(
        lambda t: jpvjp.render_vrc_pallas_diff_streamed(
            jv, t, jc, cfg, interpret=True, block_x=8), jtf, target)
    img, g = _port_value_and_grad(march_vjp.render_vrc_diff, jv, jtf, jc, cfg,
                                  target)
    np.testing.assert_allclose(img, want_img, rtol=0, atol=TOL)
    assert np.abs(want_g).sum() > 0
    np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-6)
    if alpha0:
        assert np.abs(want_g[0]).max() > 0  # the samples off the volume
