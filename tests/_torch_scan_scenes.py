"""The scenes of the scan-route tests (tests/test_torch_scan_fit*.py): the
families of fit configs that no differentiable kernel computes, on
tests/test_torch_lit_fit.py's scene (tests/test_fit_params.py:40-49), a
9x11x10 volume, 18x13 pixels, 30 samples per ray, seed 11; and the check
of one case's loss and gradients against ``jax.value_and_grad`` of the JAX
package's ``render_loss``, which takes its XLA scan on the CPU
(fit.py:124-226).  Tolerances: losses rtol 1e-4; dcolors rtol 1e-4, atol
1e-7; the light's gradients rtol 2e-3; the bounds' and every gradient of
an a5 or smooth config rtol 5e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.ops import phong as jphong

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.ops import phong
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
RTOL_LOSS = 1e-4
RTOL, ATOL = 1e-4, 1e-7  # dcolors and the density
RTOL_LIGHT = 2e-3
RTOL_LOOSE = 5e-3  # the bounds, and every gradient of a5 and smooth configs
CAM = (0.35, 0.45, 0.85)
CAM_CONIC = (0.55, 0.45, 1.3)
COLOUR_LIGHT = (1.0, 0.5, 0.5)


def _volume(channels=1):
    rng = np.random.default_rng(11)
    shape = (9, 11, 10) + ((channels,) if channels > 1 else ())
    return J.make_volume(rng.uniform(0.0, 255.0, size=shape)
                         .astype(np.float32))


def target():
    return np.random.default_rng(12).uniform(
        0.0, 1.0, (18, 13, 4)).astype(np.float32)


def _tf(k=4):
    """The default TF, or k intervals spread over [0, 1] with seeded
    colours."""
    if k == 4:
        return J.default_transfer_function()
    rng = np.random.default_rng(k)
    lo = np.sort(rng.uniform(0.0, 1.0, k)).astype(np.float32)
    lo[0] = 0.0
    up = np.minimum(lo + np.float32(0.12), np.float32(1.0)).astype(np.float32)
    up[0] = 1.0
    colors = rng.uniform(0.0, 1.0, (k, 4)).astype(np.float32)
    colors[0, 3] = 0.0
    colors[1:, 3] *= np.float32(0.3)
    return J.TransferFunction(lower=jnp.asarray(lo), upper=jnp.asarray(up),
                              colors=jnp.asarray(colors),
                              hg_g=jnp.zeros(k, jnp.float32))


def _jlight(colour=None):
    jl = jphong.default_light()
    if colour is not None:
        jl = dataclasses.replace(jl, color=jnp.asarray(colour, jnp.float32))
    return jl


def port(jv, jtf, jc, jcfg, jl=None):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    pl = None if jl is None else interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS), device="cpu")
    return pv, ptf, pc, RenderConfig.from_json(jcfg.to_json()), pl


# name: (config overrides, channels, intervals, light colour or None for no
# light fit, fit_bounds)
CASES = {
    "conic_lit": (dict(lighting=True, conic=True), 1, 4, None, False),
    "light_a5": (dict(algorithm=J.Algorithm.TEST), 1, 4, (1, 1, 1), False),
    "light_smooth": (dict(interp=J.Interp.TRILINEAR), 1, 4, (1, 1, 1), True),
    "light_4d": (dict(), 3, 4, (1, 1, 1), False),
    "light_conic": (dict(conic=True), 1, 4, (1, 1, 1), False),
    "light_lut": (dict(tf_lut=64), 1, 4, (1, 1, 1), False),
    # a light fit of a scattered render, from a light colour that is not
    # uniform: both families in one case
    "light_scattered": (dict(scattering=True), 1, 4, COLOUR_LIGHT, False),
    "light_colour": (dict(lighting=True), 1, 4, COLOUR_LIGHT, False),
    "scattered_a5": (dict(algorithm=J.Algorithm.TEST, scattering=True), 1, 4,
                     None, False),
    "scattered_smooth": (dict(interp=J.Interp.TRILINEAR, scattering=True), 1,
                         4, None, True),
    "scattered_conic": (dict(conic=True, scattering=True), 1, 4, None, False),
    "scattered_lut": (dict(tf_lut=64, scattering=True), 1, 4, None, False),
    "lit_a5": (dict(algorithm=J.Algorithm.TEST, lighting=True), 1, 4, None,
               False),
    "4d_conic": (dict(conic=True), 3, 4, None, False),
    "4d_lit": (dict(lighting=True), 3, 4, None, False),
    "4d_lut": (dict(tf_lut=64), 2, 4, None, False),
    "4d_a5": (dict(algorithm=J.Algorithm.TEST), 3, 4, None, False),
    "smooth_lit": (dict(interp=J.Interp.TRILINEAR, lighting=True), 1, 4,
                   None, True),
    "smooth_lut": (dict(interp=J.Interp.TRILINEAR, tf_lut=64), 1, 4, None,
                   True),
    "smooth_density": (dict(interp=J.Interp.TRILINEAR, density_scale=0.7), 1,
                       4, None, True),
    "k20": (dict(), 1, 20, None, False),
    "k20_a5": (dict(algorithm=J.Algorithm.TEST), 1, 20, None, False),
    "trilinear_color": (dict(interp=J.Interp.TRILINEAR_COLOR), 1, 4, None,
                        False),
    "trilinear_color_lit_conic": (dict(interp=J.Interp.TRILINEAR_COLOR,
                                       lighting=True, conic=True), 1, 4,
                                  None, False),
    # density_scale 1.7 clips scaled alphas at both bounds (TF(0)'s alpha
    # 0 off the volume): the fused routes fit these too
    "density_nearest": (dict(density_scale=1.7), 1, 4, None, False),
    "density_lut": (dict(density_scale=1.7, tf_lut=64), 1, 4, None, False),
}

# the cases the fused routes fit as well (mode="fast" does not raise)
FAST_CASES = ("density_nearest", "density_lut")


def case(name):
    over, channels, k, colour, bounds = CASES[name]
    jcfg = J.RenderConfig(width=18, height=13, samples_per_ray=30, **over)
    jc = J.Camera.initial(position=CAM_CONIC if jcfg.conic else CAM)
    jl = None if colour is None else _jlight(
        None if colour == (1, 1, 1) else colour)
    return _volume(channels), _tf(k), jc, jcfg, jl, bounds


def loose(jcfg):
    return (jcfg.algorithm is J.Algorithm.TEST
            or jcfg.interp is J.Interp.TRILINEAR)


def check_case(name):
    """The loss and every parameter's gradient of case ``name`` through the
    port's scan route against ``jax.value_and_grad`` of the JAX
    ``render_loss``; the fast route raises, naming ``mode='scan'``, and
    the default route's check (``diff/fit.diff_refusal``) sends the case
    to the scan, but on :data:`FAST_CASES`, which the kernels fit."""
    jv, jtf, jc, jcfg, jl, bounds = case(name)
    tgt = target()
    jparams = jfit.FitParams.init(jtf, fit_bounds=bounds, light=jl)
    jloss, jg = jax.value_and_grad(jfit.render_loss)(
        jparams, jtf, jv, jc, jnp.asarray(tgt), jcfg)
    pv, ptf, pc, pcfg, pl = port(jv, jtf, jc, jcfg, jl)
    params = pfit.FitParams.init(ptf, fit_bounds=bounds, light=pl)
    loss = pfit.render_loss(params, ptf, pv, pc, torch.from_numpy(tgt),
                            pcfg, mode="scan")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL_LOSS)
    rtol = RTOL_LOOSE if loose(jcfg) else RTOL
    want = np.asarray(jg.tf_colors)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(params.tf_colors.grad.numpy(), want,
                               rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(float(params.density_scale.grad),
                               float(jg.density_scale), rtol=rtol, atol=ATOL)
    if bounds:
        for got, want in ((params.tf_lower, jg.tf_lower),
                          (params.tf_upper, jg.tf_upper)):
            want = np.asarray(want)
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got.grad.numpy(), want,
                                       rtol=RTOL_LOOSE,
                                       atol=1e-6 * np.abs(want).max())
    if jl is not None:
        got = phong.light_to_vec(phong.Light(
            *(torch.zeros_like(t) if t.grad is None else t.grad
              for t in params.light.fields()))).numpy()
        want = np.asarray(jphong.light_to_vec(jg.light))
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=RTOL_LIGHT,
                                   atol=1e-6 * np.abs(want).max())
    refusal = pfit.diff_refusal(pv, ptf, pcfg, params.light)
    if name in FAST_CASES:
        assert refusal is None
        return
    assert "mode='scan'" in refusal
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        pfit.render_loss(pfit.FitParams.init(ptf, fit_bounds=bounds,
                                             light=pl),
                         ptf, pv, pc, torch.from_numpy(tgt), pcfg,
                         mode="fast")


# the a5 and smooth families (tests/test_torch_scan_fit_a5_smooth.py)
A5_SMOOTH_CASES = ("light_a5", "light_smooth", "scattered_a5",
                   "scattered_smooth", "lit_a5", "4d_a5", "smooth_lit",
                   "smooth_lut", "smooth_density", "k20_a5")
