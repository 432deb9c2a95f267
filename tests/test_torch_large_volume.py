"""Volumes beyond the TPU's resident budget, forward: the JAX package
renders them with its streamed march (K2: ``render_vrc_pallas_streamed``,
the x-blocks of the volume staged from HBM in visibility order, lit and
scattered through u8-quantized (M, S)).  On the H100 the volume stays in
device memory and K1 marches it whole, so the port's K1 path (its plain
version here, ``march_plain``) is held to the streamed kernel in interpret
mode at the JAX tests' small multi-block sizes (``block_x=8``;
tests/test_pallas_march.py): values at eps 0 within 1e-5 for both march
directions, at eps 1e-3 within 2e-3, with TF(0).alpha > 0 nothing
clipped, through a LUT, and lit or scattered within the streamed kernel's
own quantization bound (and within 2e-5 of the JAX scan, which does not
quantize).  chip_smoke.py holds K1 to the same plain version at 320^3 and
512^3 on the card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import phong as jphong

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import march
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
TOL = 1e-5  # eps 0: the streamed kernel's atol against the scan
TOL_EPS = 2e-3  # eps 1e-3 (test_streamed_matches_resident)
TOL_SCAN = 2e-5  # lit and scattered, against the JAX scan
TOL_QUANT = 6e-3  # the streamed kernel's u8 (M, S) bound
CAMS = ((0.35, 0.45, 0.85), (-0.5, 0.3, -0.8))  # both visit directions


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _k1_plain(jv, jtf, jc, cfg, eps=0.0, light=None):
    """The port's K1 path on the CPU: prep and the kernel's plain version."""
    pv, ptf, pc = _port(jv, jtf, jc)
    if light is not None:
        light = interop.light_from_numpy(
            *(np.asarray(getattr(light, k)) for k in LIGHT_FIELDS),
            device="cpu")
    a = march.prepare(pv, ptf, pc, RenderConfig.from_json(cfg.to_json()), eps,
                      light)
    return march.march_plain(a).numpy()


def _streamed(jv, jtf, jc, cfg, eps=0.0, **kw):
    return np.asarray(jpm.render_vrc_pallas_streamed(
        jv, jtf, jc, cfg, early_eps=eps, interpret=True, block_x=8, **kw))


@pytest.fixture(scope="module")
def volume():
    """tests/test_pallas_march.py's streamed scene: 20 x-planes, three
    8-plane blocks."""
    rng = np.random.default_rng(11)
    return J.make_volume(rng.uniform(0, 255, (20, 12, 11)).astype(np.float32))


@pytest.mark.parametrize("pos", CAMS)
def test_k1_matches_streamed_march(volume, pos):
    """test_streamed_matches_resident: eps 0 in both visit directions,
    eps 1e-3 in the first."""
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=pos)
    cfg = J.RenderConfig(width=20, height=14, samples_per_ray=40)
    exact = _k1_plain(volume, jtf, jc, cfg)
    np.testing.assert_allclose(exact, _streamed(volume, jtf, jc, cfg),
                               rtol=0, atol=TOL)
    assert np.abs(exact[..., :3] - 0.2).max() > 0.1  # not background only
    if pos != CAMS[0]:
        return
    early = _k1_plain(volume, jtf, jc, cfg, eps=1e-3)
    np.testing.assert_allclose(early, _streamed(volume, jtf, jc, cfg, 1e-3),
                               rtol=0, atol=TOL_EPS)
    assert np.abs(early - exact).max() <= 1.1e-3


def test_k1_alpha0_positive_unclipped():
    """test_streamed_manual_alpha0_positive_unclipped: TF(0).alpha > 0
    renders the samples off the volume and in empty bricks, so nothing may
    be clipped or skipped."""
    vol_np = np.zeros((24, 12, 11), np.float32)
    vol_np[:8] = 50.0
    jv = J.make_volume(vol_np)
    jtf = J.default_transfer_function()
    jtf = dataclasses.replace(jtf, colors=jtf.colors.at[0].set(
        jnp.asarray([0.1, 0.2, 0.3, 0.15])))
    cfg = J.RenderConfig(width=16, height=14, samples_per_ray=30)
    jc = J.Camera.initial(position=(0.9, 0.35, 0.45))
    got = _k1_plain(jv, jtf, jc, cfg)
    np.testing.assert_allclose(got, _streamed(jv, jtf, jc, cfg), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(
        got, np.asarray(jraycast.render_vrc(jv, jtf, jc, cfg, mode="fast")),
        rtol=0, atol=TOL)


def test_k1_lut_matches_streamed_march():
    """test_streamed_lut_matches_xla's scene: LUT indices of a 96-entry
    table, the second visit direction."""
    rng = np.random.default_rng(13)
    jv = J.make_volume(rng.uniform(0, 255, (20, 12, 11)).astype(np.float32))
    jtf = J.default_transfer_function()
    cfg = J.RenderConfig(width=20, height=14, samples_per_ray=40, tf_lut=96)
    jc = J.Camera.initial(position=CAMS[1])
    np.testing.assert_allclose(_k1_plain(jv, jtf, jc, cfg),
                               _streamed(jv, jtf, jc, cfg), rtol=0, atol=TOL)


@pytest.mark.parametrize("kw", [dict(lighting=True), dict(scattering=True)])
def test_k1_lit_and_scattered_large(volume, kw):
    """Lit and scattered: the streamed kernel quantizes (M, S) to u8, so
    the port (f32 (M, S)) is held to the JAX scan at 2e-5 and to the
    streamed kernel within its own bound (test_streamed_lighting_matches_
    xla)."""
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAMS[0])
    cfg = J.RenderConfig(width=20, height=14, samples_per_ray=40, **kw)
    got = _k1_plain(volume, jtf, jc, cfg)
    np.testing.assert_allclose(
        got, np.asarray(jraycast.render_vrc(volume, jtf, jc, cfg,
                                            mode="fast")),
        rtol=0, atol=TOL_SCAN)
    assert np.abs(got - _streamed(volume, jtf, jc, cfg)).max() <= TOL_QUANT


def test_k1_lit_flat_light_exact():
    """test_streamed_lit_quantization_exact_when_flat: with ambient 1 and
    no diffuse or specular term the factors are constant, the streamed
    kernel's quantization is exact, and the port's lit march is held to it
    at the unquantized tolerance, as to the unlit march."""
    rng = np.random.default_rng(31)
    jv = J.make_volume(rng.uniform(0, 255, (20, 12, 11)).astype(np.float32))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAMS[0])
    flat = dataclasses.replace(
        jphong.default_light(), ambient=jnp.asarray(1.0, jnp.float32),
        diffuse=jnp.asarray(0.0, jnp.float32),
        specular=jnp.asarray(0.0, jnp.float32))
    cfg = J.RenderConfig(width=20, height=14, samples_per_ray=40,
                         lighting=True)
    got = _k1_plain(jv, jtf, jc, cfg, light=flat)
    np.testing.assert_allclose(got, _streamed(jv, jtf, jc, cfg, light=flat),
                               rtol=0, atol=TOL)
    unlit = _k1_plain(jv, jtf, jc, cfg.replace(lighting=False))
    np.testing.assert_allclose(got, unlit, rtol=0, atol=TOL)
