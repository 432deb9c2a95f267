"""Port parity, the scan route end to end: 3 steps of
``fit_transfer_function(mode="scan")`` per family of configs that no
differentiable kernel computes, against the JAX package's
``fit_transfer_function`` (its XLA scan on the CPU); the checkpointed scan
(models/raycast.py) against the unchunked one; ``Interp.TRILINEAR_COLOR``
renders (the JAX package's a1 colour-mix branch, raycast.py:168-174)
against the JAX scan; the CLI's ``fit --mode scan``.  The scene and the
cases are tests/_torch_scan_scenes.py's: losses rtol 1e-4, parameters
within 1e-5 after 3 steps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import phong as jphong

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.models import raycast
from volumerenderingproject_tpu_torch.ops import phong
from volumerenderingproject_tpu_torch.scene.transfer_function import from_text

import _torch_scan_scenes as S

TOL_PARAMS = 1e-5
TOL_RENDER = 2e-5
STEPS = 3

# one case a family: conic lit, light, scattered, lit a5, 4-D, smooth
# (a bound fit), more than 16 intervals, Interp.TRILINEAR_COLOR
FAMILIES = ["conic_lit", "light_colour", "scattered_conic", "lit_a5",
            "4d_lit", "smooth_lit", "k20", "trilinear_color"]


def _jrender(jv, jtf, jc, jcfg, jl=None):
    scan = (jraycast.render_test if jcfg.algorithm is J.Algorithm.TEST
            else jraycast.render_vrc)
    return np.asarray(scan(jv, jtf, jc, jcfg, mode="fast", light=jl))


@pytest.mark.parametrize("name", FAMILIES)
def test_scan_fit_matches_jax(name):
    """3 Adam steps through the scan route against the JAX fit: the losses
    and every parameter (the light's ten too) agree, and the fit moves."""
    jv, jtf, jc, jcfg, jl, bounds = S.case(name)
    target = _jrender(jv, jtf, jc, jcfg, jphong.default_light()
                      if jl is not None else None)
    if jl is not None:  # from another light (the light-recovery start)
        jl = dataclasses.replace(jl, ambient=jnp.asarray(0.7, jnp.float32),
                                 diffuse=jnp.asarray(0.2, jnp.float32))
    colors = np.asarray(jtf.colors).copy()
    colors[1:, :3] += np.float32(0.2)
    if jv.channels > 1:  # the data gives a 4-D volume's rgb: move alpha
        colors[1:, 3] *= np.float32(0.8)
    jtf = dataclasses.replace(jtf, colors=jnp.asarray(colors))
    jparams, jlosses = jfit.fit_transfer_function(
        jv, jc, jnp.asarray(target), jtf, jcfg, steps=STEPS,
        learning_rate=1e-2, fit_bounds=bounds, light=jl)
    pv, ptf, pc, pcfg, pl = S.port(jv, jtf, jc, jcfg, jl)
    pparams, plosses = pfit.fit_transfer_function(
        pv, pc, target, ptf, pcfg, steps=STEPS, learning_rate=1e-2,
        fit_bounds=bounds, light=pl, device="cpu", mode="scan")
    np.testing.assert_allclose(plosses, jlosses, rtol=S.RTOL_LOSS)
    np.testing.assert_allclose(pparams.tf_colors.detach().numpy(),
                               np.asarray(jparams.tf_colors), rtol=0,
                               atol=TOL_PARAMS)
    np.testing.assert_allclose(float(pparams.density_scale.detach()),
                               float(jparams.density_scale), rtol=0,
                               atol=TOL_PARAMS)
    if bounds:
        for got, want in ((pparams.tf_lower, jparams.tf_lower),
                          (pparams.tf_upper, jparams.tf_upper)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=0,
                                       atol=TOL_PARAMS)
    if jl is not None:
        np.testing.assert_allclose(
            phong.light_to_vec(pparams.light).detach().numpy(),
            np.asarray(jphong.light_to_vec(jparams.light)), rtol=0,
            atol=TOL_PARAMS)
    assert not np.array_equal(pparams.tf_colors.detach().numpy(), colors)


@pytest.mark.parametrize("over", [
    {}, dict(lighting=True), dict(conic=True), dict(lighting=True, conic=True,
                                                    tf_lut=64),
    dict(scattering=True, density_scale=0.6)],
    ids=["plain", "lit", "conic", "lit_conic_lut", "scattered"])
def test_trilinear_color_renders_match_jax(over):
    """``Interp.TRILINEAR_COLOR`` through the scan (and its back-to-front
    and segment forms) against the JAX scan; the fused march raises,
    naming ``mode='scan'``."""
    jv, jtf, jc, jcfg, _, _ = S.case("trilinear_color")
    jcfg = jcfg.replace(**over)
    if jcfg.conic:
        jc = J.Camera.initial(position=S.CAM_CONIC)
    want = _jrender(jv, jtf, jc, jcfg)
    pv, ptf, pc, pcfg, _ = S.port(jv, jtf, jc, jcfg)
    got = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_RENDER)
    nearest = P.render(pv, ptf, pc, pcfg.replace(interp=P.Interp.NEAREST),
                       mode="scan", device="cpu")
    assert float((got - nearest).abs().max()) > 1e-3
    ref = P.render(pv, ptf, pc, pcfg, mode="reference", device="cpu")
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=TOL_RENDER)
    c, t = raycast.render_vrc_segment(pv, ptf, pc, pcfg, x_offset=4,
                                      local_width=6)
    seg = torch.cat([c + t * torch.tensor(pcfg.background[:3]),
                     torch.ones_like(t)], dim=-1)
    np.testing.assert_allclose(seg.numpy(), want[4:10], rtol=0,
                               atol=TOL_RENDER)
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        P.render(pv, ptf, pc, pcfg, mode="fast", device="cpu")


def test_cli_fit_mode_scan_conic_lit(tmp_path, capsys):
    """``fit --mode scan --lighting --conic --fit-light`` on the CPU fits
    through the scan against its own target (rendered in scan mode too) and
    writes a TF file that parses; without ``--mode scan`` the same call
    raises, naming ``mode='scan'``; ``render --mode scan --interp
    trilinear_color`` writes a PNG."""
    out = str(tmp_path / "fitted.txt")
    args = ["fit", "--data", "sphere", "--width", "12", "--height", "10",
            "--spr", "16", "--steps", "2", "--lighting", "--conic",
            "--camera", "0.55,0.45,1.3", "--fit-light", "--device", "cpu"]
    assert cli.main(args + ["--mode", "scan", "--out-tf", out]) == 0
    printed = capsys.readouterr().out
    assert "fit: loss" in printed and "fitted light:" in printed
    with open(out) as f:
        fitted = from_text(f.read(), device="cpu")
    assert fitted.num_intervals == 4
    assert "loss 0.000000" in printed  # the self-target is the scan's
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        cli.main(args + ["--mode", "fast"])
    png = str(tmp_path / "tc.png")
    assert cli.main(["render", "--width", "12", "--height", "10", "--spr",
                     "16", "--interp", "trilinear_color", "--mode", "scan",
                     "--device", "cpu", "--out", png]) == 0
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _scan_grads(pv, ptf, pc, pcfg, target, pl=None):
    params = pfit.FitParams.init(ptf, light=pl)
    loss = pfit.render_loss(params, ptf, pv, pc, torch.from_numpy(target),
                            pcfg, mode="scan")
    loss.backward()
    return [loss.detach()] + [p.grad for p in params.parameters()]


@pytest.mark.parametrize("name", ["conic_lit", "light_scattered", "lit_a5",
                                  "smooth_lit", "trilinear_color"])
def test_checkpointed_scan_is_bit_equal(name, monkeypatch):
    """The scan in checkpointed chunks of 7 samples (30 a ray: the last
    chunk is short) gives the loss and the gradients of the unchunked scan
    bit for bit, and does run in chunks."""
    jv, jtf, jc, jcfg, jl, _ = S.case(name)
    pv, ptf, pc, pcfg, pl = S.port(jv, jtf, jc, jcfg, jl)
    tgt = S.target()
    calls = []

    def counted(*args, **kw):
        calls.append(args[-1] - args[-2])
        return torch.utils.checkpoint.checkpoint(*args, **kw)

    monkeypatch.setattr(raycast, "checkpoint", counted)
    monkeypatch.setattr(raycast, "SCAN_CHUNK", 7)
    chunked = _scan_grads(pv, ptf, pc, pcfg, tgt, pl)
    assert calls == [7, 7, 7, 7, 2]
    monkeypatch.setattr(raycast, "scan_chunk", lambda *objs: None)
    whole = _scan_grads(pv, ptf, pc, pcfg, tgt, pl)
    assert len(calls) == 5
    assert len(chunked) == len(whole)
    for a, b in zip(chunked, whole):
        assert (a is None and b is None) or torch.equal(a, b)


def test_no_checkpoint_without_grad(monkeypatch):
    """A render that records no graph takes the plain loop."""
    jv, jtf, jc, jcfg, _, _ = S.case("conic_lit")
    pv, ptf, pc, pcfg, _ = S.port(jv, jtf, jc, jcfg)

    def refuse(*args, **kw):
        raise AssertionError("checkpointed without a graph")

    monkeypatch.setattr(raycast, "checkpoint", refuse)
    assert raycast.scan_chunk(pv, ptf, pc, None) is None
    P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    colors = ptf.colors.clone().requires_grad_()
    tf2 = P.TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g)
    assert raycast.scan_chunk(pv, tf2, pc, None) == raycast.SCAN_CHUNK
    with torch.no_grad():
        assert raycast.scan_chunk(pv, tf2, pc, None) is None
        P.render(pv, tf2, pc, pcfg, mode="scan", device="cpu")


def test_unknown_mode_raises():
    jv, jtf, jc, jcfg, _, _ = S.case("k20")
    pv, ptf, pc, pcfg, _ = S.port(jv, jtf, jc, jcfg)
    with pytest.raises(ValueError, match="unknown mode"):
        pfit.render_loss(pfit.FitParams.init(ptf), ptf, pv, pc,
                         torch.zeros(18, 13, 4), pcfg, mode="xla")
