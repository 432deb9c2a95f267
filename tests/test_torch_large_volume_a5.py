"""Volumes beyond the TPU's resident budget, a5: the JAX package renders
them through a streamed id grid (K3's ``id_stream``, lit and scattered
through u8-quantized (M, S)) and fits them with its streamed a5 backward
(K7: ``render_test_pallas_diff_streamed``, the edge blocks owning the
samples off the volume).  On the H100 the id grid stays in device memory,
so the port's K3 and K6 paths (their plain versions here) are held to
those kernels in interpret mode at the JAX tests' multi-block sizes
(``id_stream_block=8``; tests/test_pallas_a5.py): values within 1e-5,
colour gradients within rtol 1e-4 / atol 1e-6 with TF(0).alpha 0.05, and
the scattered march within 2e-5 of the JAX scan and within the streamed
kernel's u8 (M, S) bound.  chip_smoke.py holds K3 and K6 to the same plain
versions at 320^3 and 512^3 on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import pallas_a5 as jpa5

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import a5, a5_vjp
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL = 1e-5  # values, the streamed kernels' atol against the scan
TOL_SCAN = 2e-5  # scattered a5 against the JAX scan
TOL_QUANT = 6e-3  # the streamed kernel's u8 (M, S) bound


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


def test_k6_matches_streamed_a5_backward():
    """test_a5_streamed_diff_values_and_grads with TF(0).alpha 0.05: the
    samples off the volume render and carry gradients."""
    rng = np.random.default_rng(17)
    jv = J.make_volume(rng.uniform(-30, 255, (24, 14, 150)).astype(np.float32))
    cfg = J.RenderConfig(width=20, height=14, samples_per_ray=24,
                         algorithm=J.Algorithm.TEST)
    target = rng.uniform(0, 1, size=(20, 14, 4)).astype(np.float32)
    jtf = _with_alpha0(J.default_transfer_function(), 0.05)
    jc = J.Camera.initial(position=(-0.7, 0.2, 0.6))
    want_img, want_g = _jax_value_and_grad(
        lambda t: jpa5.render_test_pallas_diff_streamed(
            jv, t, jc, cfg, interpret=True, id_stream_block=8), jtf, target)
    img, g = _port_value_and_grad(a5_vjp.render_test_diff, jv, jtf, jc, cfg,
                                  target)
    np.testing.assert_allclose(img, want_img, rtol=0, atol=TOL)
    assert np.abs(want_g[0]).max() > 0
    np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-6)


def test_k3_scattered_matches_a5_id_stream():
    """test_a5_id_stream_blocks, scattered: the port's baked a5 march
    against the JAX a5 scan at 2e-5, and against the streamed kernel
    within its u8 (M, S) bound."""
    rng = np.random.default_rng(9)
    jv = J.make_volume(rng.uniform(-30, 255, (24, 14, 150)).astype(np.float32))
    jtf = J.default_transfer_function()
    cfg = J.RenderConfig(width=16, height=16, samples_per_ray=24,
                         algorithm=J.Algorithm.TEST, scattering=True)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    pv, ptf, pc = _port(jv, jtf, jc)
    got = a5.march_a5_plain(a5.prepare_a5(
        pv, ptf, pc, RenderConfig.from_json(cfg.to_json()), 0.0)).numpy()
    want = np.asarray(jraycast.render_test(jv, jtf, jc, cfg, mode="fast"))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCAN)
    streamed = np.asarray(jpa5.render_test_pallas(
        jv, jtf, jc, cfg, early_eps=0.0, interpret=True, id_stream_block=8))
    assert np.abs(got - streamed).max() <= TOL_QUANT
