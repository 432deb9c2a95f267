"""Scattered fits (``config.scattering``) of the port against the JAX
package: ``render_vrc_scatter_diff`` (K1 baked forward, K4 baked backward
and one tangent march of K1 baked per interval, on their plain versions
here) against the JAX scatter core ``render_vrc_pallas_diff_scatter`` in
interpret mode and against ``jax.grad`` through the XLA scan, the JAX
scatter core's own repairs (the bake at density 1, exact ``hg_g``
cotangents), the
marches a step takes, 5 fit steps against the JAX fit, what still raises,
and the CLI.  The CUDA kernels are held against their plain versions on
the card by chip_smoke.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import pallas_march_vjp as jpvjp
from volumerenderingproject_tpu.scene.transfer_function import (
    TransferFunction as JTF)

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ops import march_vjp, phong
from volumerenderingproject_tpu_torch.utils.config import Algorithm, Interp

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL_VALUE = 1e-5  # the differentiable render vs the JAX scan
TOL_CORE = 1e-4  # gradients vs the JAX scatter core (rtol; atol of the max)
TOL_SCAN_GRAD = 1e-3  # and vs jax.grad through the XLA scan
HG = [0.0, 0.3, -0.2, 0.5]  # test_scatter_diff_matches_xla's materials


@pytest.fixture(scope="module")
def scene():
    """A small volume with negative voxels and cal_max 200.9, every
    default-TF interval present, a camera whose rays cross it and the empty
    space around it, a target that keeps every pixel's gradient non-trivial
    and materials of non-zero g."""
    rng = np.random.default_rng(5)
    jv = J.make_volume(rng.uniform(-30.0, 255.0, (9, 11, 10))
                       .astype(np.float32), cal_max=200.9)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=12, height=10, samples_per_ray=20,
                         scattering=True)
    target = rng.uniform(0.0, 1.0, (12, 10, 4)).astype(np.float32)
    jtf = dataclasses.replace(J.default_transfer_function(),
                              hg_g=jnp.asarray(HG, jnp.float32))
    return jv, jtf, jc, cfg, target


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _jax_loss(jv, jtf, jc, cfg, target, fused):
    def loss(colors, hg):
        tf2 = JTF(jtf.lower, jtf.upper, colors, hg)
        if fused:
            img = jpvjp.render_vrc_pallas_diff_scatter(jv, tf2, jc, cfg,
                                                       interpret=True)
        else:
            img = jraycast.render_vrc(jv, tf2, jc, cfg, mode="fast")
        return jnp.mean((img[..., :3] - target[..., :3]) ** 2)

    return loss


def _port_loss_and_grads(jv, jtf, jc, cfg, target):
    pv, ptf, pc = _port(jv, jtf, jc)
    colors = ptf.colors.clone().requires_grad_()
    hg = ptf.hg_g.clone().requires_grad_()
    img = march_vjp.render_vrc_diff(
        pv, P.TransferFunction(ptf.lower, ptf.upper, colors, hg), pc,
        P.RenderConfig.from_json(cfg.to_json()), device="cpu")
    loss = torch.mean((img[..., :3] - torch.tensor(target[..., :3])) ** 2)
    loss.backward()
    return (loss.item(), img.detach().numpy(), colors.grad.numpy(),
            hg.grad.numpy())


def _close(got, want, rtol):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=float(np.abs(want).max()) * 1e-4)


def test_scatter_grad_matches_jax_core(scene):
    """dL/dcolors (the transmittance chain included) and dL/dhg_g against
    the JAX scatter core in interpret mode, at a static density_scale of
    1.7: the core folds it into the alpha column once and bakes at density
    1, and so does the port."""
    jv, jtf, jc, cfg, target = scene
    cfg = cfg.replace(density_scale=1.7)
    f = jax.jit(jax.value_and_grad(_jax_loss(jv, jtf, jc, cfg, target, True),
                                   argnums=(0, 1)))
    jl, (jgc, jgh) = f(jtf.colors, jtf.hg_g)
    pl, img, pgc, pgh = _port_loss_and_grads(jv, jtf, jc, cfg, target)
    want = np.asarray(jraycast.render_vrc(jv, jtf, jc, cfg, mode="fast"))
    np.testing.assert_allclose(img, want, rtol=0, atol=TOL_VALUE)
    np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
    _close(pgc, jgc, TOL_CORE)
    _close(pgh, jgh, TOL_CORE)
    # the density fold reaches T_light: dropping the fold from the bake's
    # alpha (density applied once, not zero times) moves the image
    unfolded = np.asarray(jraycast.render_vrc(
        jv, jtf, jc, cfg.replace(density_scale=1.0), mode="fast"))
    assert np.abs(img - unfolded).max() > 1e-3


@pytest.mark.parametrize("kw", [dict(), dict(lighting=True)])
def test_scatter_grad_matches_jax_scan(scene, kw):
    """dL/dcolors and dL/dhg_g against jax.grad through the XLA scan,
    unlit and lit."""
    jv, jtf, jc, cfg, target = scene
    cfg = cfg.replace(**kw)
    jl, (jgc, jgh) = jax.jit(jax.value_and_grad(
        _jax_loss(jv, jtf, jc, cfg, target, False), argnums=(0, 1)))(
            jtf.colors, jtf.hg_g)
    pl, _, pgc, pgh = _port_loss_and_grads(jv, jtf, jc, cfg, target)
    np.testing.assert_allclose(pl, float(jl), rtol=1e-5)
    _close(pgc, jgc, TOL_SCAN_GRAD)
    _close(pgh, jgh, TOL_SCAN_GRAD)


@pytest.mark.parametrize("hg_grad", [False, True])
def test_scatter_step_marches(scene, monkeypatch, hg_grad):
    """A scattered step runs 1 + K + 1 forward marches of the baked variant
    (the render, one tangent march per interval, the shared S -> 0 base)
    and 1 backward march; ``hg_g`` adds K only where it requires grad."""
    jv, jtf, jc, cfg, target = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = march_vjp._forward, march_vjp._backward

    def count_fwd(a):
        assert march_vjp.march.variant(a) == "baked"
        calls["fwd"] += 1
        return fwd(a)

    def count_bwd(a, *g):
        assert march_vjp.march.variant(a) == "baked"
        calls["bwd"] += 1
        return bwd(a, *g)

    monkeypatch.setattr(march_vjp, "_forward", count_fwd)
    monkeypatch.setattr(march_vjp, "_backward", count_bwd)
    colors = ptf.colors.clone().requires_grad_()
    hg = ptf.hg_g.clone().requires_grad_(hg_grad)
    img = march_vjp.render_vrc_diff(
        pv, P.TransferFunction(ptf.lower, ptf.upper, colors, hg), pc,
        P.RenderConfig.from_json(cfg.to_json()), device="cpu")
    img.sum().backward()
    k = ptf.num_intervals
    assert calls == {"fwd": 1 + k + 1 + (k if hg_grad else 0), "bwd": 1}
    assert (hg.grad is not None) == hg_grad


def test_scatter_fit_matches_jax(scene):
    """5 steps of a scattered colour fit against the JAX package's
    ``fit_transfer_function`` (its XLA scan on the CPU): losses rtol 1e-4,
    parameters within 1e-5."""
    jv, jtf, jc, cfg, _ = scene
    target = np.asarray(jraycast.render_vrc(jv, jtf, jc, cfg, mode="fast"))
    colors = np.asarray(jtf.colors).copy()
    colors[1:, :3] += np.float32(0.2)
    jtf = dataclasses.replace(jtf, colors=jnp.asarray(colors))
    jparams, jlosses = jfit.fit_transfer_function(
        jv, jc, jnp.asarray(target), jtf, cfg, steps=5, learning_rate=1e-2)
    pv, ptf, pc = _port(jv, jtf, jc)
    pparams, plosses = pfit.fit_transfer_function(
        pv, pc, target, ptf, P.RenderConfig.from_json(cfg.to_json()), steps=5,
        learning_rate=1e-2, device="cpu")
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(pparams.tf_colors.detach().numpy(),
                               np.asarray(jparams.tf_colors), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(pparams.density_scale.detach()),
                               float(jparams.density_scale), rtol=0,
                               atol=1e-5)
    assert plosses[-1] < plosses[0]


@pytest.mark.parametrize("cfg_kw,fit_light,item", [
    (dict(algorithm=Algorithm.TEST), False, "mode='scan'"),
    (dict(interp=Interp.TRILINEAR), False, "mode='scan'"),
    (dict(), True, "mode='scan'"),
    (dict(conic=True), False, "mode='scan'"),
    (dict(tf_lut=256), False, "mode='scan'"),
])
def test_unported_scatter_fits_raise(scene, cfg_kw, fit_light, item):
    """Scattered fits the fused marches do not compute raise in fast mode,
    naming ``mode='scan'`` (the JAX package fits them through its XLA
    scan), and none falls back to another route; the scan route fits them
    (its gradients against the JAX package's: tests/test_torch_scan_fit.py
    and tests/test_torch_scan_fit_a5_smooth.py)."""
    jv, jtf, jc, cfg, target = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json()).replace(**cfg_kw)
    light = phong.default_light(device="cpu") if fit_light else None
    if cfg_kw.get("algorithm") is None and cfg_kw.get("interp") is None:
        assert not march_vjp.diff_eligible(pv, ptf, pcfg) or fit_light
    with pytest.raises(NotImplementedError, match=item):
        pfit.fit_transfer_function(pv, pc, target, ptf, pcfg, steps=1,
                                   device="cpu", light=light, mode="fast")
    params, losses = pfit.fit_transfer_function(
        pv, pc, target, ptf, pcfg, steps=1, device="cpu", light=light,
        mode="scan")
    assert np.isfinite(losses[0])
    assert not torch.equal(params.tf_colors, ptf.colors)


def test_scatter_fit_eligible(scene):
    jv, jtf, jc, cfg, _ = scene
    pv, ptf, _ = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    assert march_vjp.diff_scatter_eligible(pv, ptf, pcfg)
    assert march_vjp.diff_eligible(pv, ptf, pcfg)
    assert march_vjp.diff_scatter_eligible(pv, ptf, pcfg.replace(
        lighting=True))
    assert not march_vjp.diff_scatter_eligible(pv, ptf, pcfg.replace(
        scattering=False))
    assert not march_vjp.diff_light_eligible(pv, ptf, pcfg)
    odd = dataclasses.replace(phong.default_light(device="cpu"),
                              color=torch.tensor([1.0, 0.5, 0.5]))
    assert not march_vjp.diff_scatter_eligible(pv, ptf, pcfg, odd)


@pytest.mark.parametrize("algorithm", ["vrc", "test"])
def test_cli_scattering(tmp_path, algorithm):
    """``render --scattering`` (a1 and a5) and ``fit --scattering`` (a1)
    on the CPU; the render writes what ``render`` returns for the
    scattered config, brighter than the unscattered one."""
    from PIL import Image

    out = os.path.join(tmp_path, "s.png")
    base = ["--width", "20", "--height", "16", "--spr", "24", "--device",
            "cpu", "--algorithm", algorithm]
    assert cli.main(["render", *base, "--scattering",
                     "--scattering-strength", "2.0", "--out", out]) == 0
    plain = os.path.join(tmp_path, "p.png")
    assert cli.main(["render", *base, "--out", plain]) == 0
    got = np.asarray(Image.open(out).convert("RGB"), np.int64)
    ref = np.asarray(Image.open(plain).convert("RGB"), np.int64)
    assert got.shape == (16, 20, 3) and (got - ref).sum() > 0
    if algorithm == "vrc":
        tf_out = os.path.join(tmp_path, "tf.txt")
        assert cli.main(["fit", *base, "--scattering", "--steps", "2",
                         "--target", out, "--out-tf", tf_out]) == 0
        assert os.path.getsize(tf_out) > 0
