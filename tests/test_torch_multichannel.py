"""4-D multichannel volumes in the port against the JAX package: the
``rgb_sphere`` fixture, the multichannel sampler, the fused march's prep
(the mean-id grid, its brick map and the channel grids), the a1 and a5
scans, the fused march's plain version (``march_plain``: the CUDA mc
variant's arithmetic) against the Pallas kernel in interpret mode, the
backward's plain version against ``jax.grad`` through the Pallas
multichannel diff kernels, two fit steps, the 4-D NIfTI load, the CLI, and
what raises.  The CUDA kernels themselves are held against those plain
versions on the card by chip_smoke.py."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.ingest import load_nifti as jload_nifti
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import pallas_march_vjp as jpv

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import load_nifti, synthetic
from volumerenderingproject_tpu_torch.models import raycast
from volumerenderingproject_tpu_torch.ops import march, march_vjp, phong
from volumerenderingproject_tpu_torch.scene.transfer_function import from_text
from volumerenderingproject_tpu_torch.utils.config import Algorithm, Interp

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL_SAMPLE = 1e-6  # sampler vs JAX's
TOL_SCAN = 2e-5  # scans vs JAX's render_vrc(mode="fast")
TOL_FUSED = 1e-5  # march_plain vs the Pallas kernel in interpret mode
GRAD_RTOL = 1e-4  # dL/dcolors and fit losses vs JAX


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _random_volume(c, cal_max=200.9, seed=9):
    """A seeded [10, 11, 9, C] volume with negatives, at a cal_max whose
    trunc differs from it (the channels take the float cal_max)."""
    rng = np.random.default_rng(seed + c)
    return J.make_volume(rng.uniform(-30, 255, (10, 11, 9, c))
                         .astype(np.float32), cal_max=cal_max)


CAMERA = J.Camera.initial(position=(0.3, 0.4, 0.9))
CONFIG = J.RenderConfig(width=16, height=12, samples_per_ray=20)


def test_rgb_sphere_matches_jax():
    jv = jsynthetic.rgb_sphere(16)
    pv = synthetic.rgb_sphere(16, device="cpu")
    assert (pv.dims, pv.channels) == (jv.dims, jv.channels) == ((16,) * 3, 3)
    np.testing.assert_array_equal(pv.data.numpy(), np.asarray(jv.data))
    assert float(pv.cal_max) == float(jv.cal_max)


def test_interop_carries_4d_volume():
    jv = _random_volume(4)
    pv, _, _ = _port(jv, J.default_transfer_function(), CAMERA)
    assert (pv.dims, pv.channels) == ((10, 11, 9), 4)
    np.testing.assert_array_equal(pv.data.numpy(), np.asarray(jv.data))
    assert float(pv.cal_max) == np.float32(200.9)


@pytest.mark.parametrize("c", [2, 3, 4])
def test_sampler_matches_jax(c):
    """The multichannel sampler at seeded points in and around the volume
    (the float cal_max 200.9; negatives clamped; 0 off the volume)."""
    jv = _random_volume(c)
    jtf = J.default_transfer_function()
    pv, ptf, _ = _port(jv, jtf, CAMERA)
    rng = np.random.default_rng(c)
    p = rng.uniform(-0.1, 1.1, (40, 30, 3)).astype(np.float32)
    want = np.asarray(jraycast._vrc_sample_rgba_multichannel(
        jnp.asarray(p), jv, jtf, CONFIG))
    got, _, valid = raycast._vrc_sample_rgba_multichannel(
        torch.tensor(p), pv, ptf)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_SAMPLE)
    assert 0.2 < float(valid.float().mean()) < 0.9


@pytest.mark.parametrize("c", [2, 3, 4])
def test_mean_ids_and_bricks_match_jax(c):
    """The mean-id grid equals JAX's ``classify_index(mean(norm))`` (an ulp
    of the mean moves a voxel across a bound; a bound is put on the means
    of many voxels here), and the brick map and channel grids equal the
    JAX prep's (pallas_march.py:1612-1641)."""
    jv = _random_volume(c)
    data = np.asarray(jv.data)
    norm = np.maximum(data, 0.0) / np.float32(200.9)
    mean = np.asarray(jnp.mean(jnp.asarray(norm), axis=-1))
    tf = J.default_transfer_function()
    # bounds at means that occur, so an ulp decides their intervals
    lower = np.asarray(tf.lower).copy()
    upper = np.asarray(tf.upper).copy()
    lower[2], upper[1] = mean.flat[7], mean.flat[11]
    jtf = J.TransferFunction(jnp.asarray(lower), jnp.asarray(upper),
                             tf.colors, tf.hg_g)
    pv, ptf, _ = _port(jv, jtf, CAMERA)
    ids, id0, chans = march.mc_grids(pv, ptf)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(jtf.classify_index(mean)))
    assert int(id0) == int(jtf.classify_index(jnp.zeros((), jnp.float32)))
    occ, nb = march.brick_occupancy(ids, ptf.colors)
    jocc, jnb = jpm.brick_occupancy(jnp.asarray(mean), jtf,
                                    jnp.ones((), jnp.float32))
    assert tuple(nb) == tuple(jnb)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    g = 1 if c < 3 else 3
    np.testing.assert_array_equal(chans.numpy(),
                                  np.moveaxis(np.asarray(norm)[..., :g], -1, 0))


@pytest.mark.parametrize("c,kw", [
    (2, {}), (3, {}), (4, {}), (3, dict(conic=True)), (4, dict(conic=True)),
    (3, dict(density_scale=1.7)), (2, dict(density_scale=0.45, conic=True)),
    (3, dict(lighting=True)), (2, dict(lighting=True, conic=True)),
    (3, dict(tf_lut=64)),
])
def test_scans_match_jax(c, kw):
    """The a1 scans (front to back and back to front) against JAX's: ortho
    and conic, density_scale, lit on channel 0's gradient, a LUT that both
    ignore; and the fused march (its plain version here) where it renders."""
    jv = _random_volume(c)
    jtf = J.default_transfer_function()
    cfg = CONFIG.replace(**kw)
    pv, ptf, pc = _port(jv, jtf, CAMERA)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    want = np.asarray(jraycast.render_vrc(jv, jtf, CAMERA, cfg, mode="fast"))
    for mode in ("scan", "reference"):
        got = P.render(pv, ptf, pc, pcfg, mode=mode, device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCAN)
    if not (cfg.lighting or cfg.tf_lut):
        fused = P.render(pv, ptf, pc, pcfg, device="cpu").numpy()
        np.testing.assert_allclose(fused, want, rtol=0, atol=TOL_SCAN)
    fg = (np.abs(want[..., :3] - 0.2).max(-1) > 0.05).mean()
    assert fg > 0.05


@pytest.mark.parametrize("name", ["rgb_sphere16", "c2", "c4"])
def test_march_plain_matches_pallas_interpret(name):
    """The volumes of tests/test_multichannel.py:142-170 (C = 3, 2, 4):
    ``march_plain``'s mc branch against the fused multichannel Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(9)
    vols = {"rgb_sphere16": jsynthetic.rgb_sphere(16)}
    for c in (2, 4):
        vols[f"c{c}"] = J.make_volume(
            rng.uniform(0, 255, (10, 11, 9, c)).astype(np.float32))
    jv, jtf = vols[name], J.default_transfer_function()
    want = np.asarray(jpm.render_vrc_pallas(jv, jtf, CAMERA, CONFIG,
                                            early_eps=0.0, interpret=True))
    pv, ptf, pc = _port(jv, jtf, CAMERA)
    a = march.prepare(pv, ptf, pc, P.RenderConfig.from_json(
        CONFIG.to_json()), 0.0)
    assert march.variant(a) == "mc"
    assert a.chans.shape[0] == (1 if jv.channels == 2 else 3)
    got = march.march_plain(a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_FUSED)


def test_bwd_plain_matches_jax_grad():
    """dL/dcolors of a seeded cotangent: the plain backward (K4 mc's
    arithmetic) through ``render_vrc_diff`` against ``jax.grad`` through
    ``render_vrc_pallas_diff_multichannel`` in interpret mode; the rgb
    columns are exactly 0 in both."""
    jv, jtf = jsynthetic.rgb_sphere(16), J.default_transfer_function()
    g = np.random.default_rng(3).normal(0, 1, (16, 12, 4)).astype(np.float32)

    def loss(colors):
        tf2 = J.TransferFunction(jtf.lower, jtf.upper, colors, jtf.hg_g)
        return jnp.sum(jpv.render_vrc_pallas_diff_multichannel(
            jv, tf2, CAMERA, CONFIG, interpret=True) * g)

    want = np.asarray(jax.grad(loss)(jtf.colors))
    pv, ptf, pc = _port(jv, jtf, CAMERA)
    colors = ptf.colors.clone().requires_grad_()
    img = march_vjp.render_vrc_diff(
        pv, P.TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g), pc,
        P.RenderConfig.from_json(CONFIG.to_json()), device="cpu")
    (img * torch.tensor(g)).sum().backward()
    got = colors.grad.numpy()
    assert not got[:, :3].any() and not want[:, :3].any()
    assert np.abs(want[:, 3]).max() > 0
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(want).max())


def test_fit_matches_jax():
    """Two fit steps from seeded alphas: the port (K1/K4 mc's plain
    versions) against the JAX fit on the CPU (its XLA scan), and the rgb
    colours do not move."""
    jv = _random_volume(3, cal_max=255.0)
    jtf = J.default_transfer_function()
    cfg = CONFIG.replace(density_scale=0.8)
    target = np.asarray(jraycast.render_vrc(jv, jtf, CAMERA, cfg))
    colors = np.asarray(jtf.colors).copy()
    colors[1:, 3] *= np.float32(0.6)
    _, jlosses = jfit.fit_transfer_function(
        jv, CAMERA, target, J.TransferFunction(jtf.lower, jtf.upper,
                                               jnp.asarray(colors), jtf.hg_g),
        cfg, steps=2, learning_rate=1e-2)
    pv, ptf, pc = _port(jv, jtf, CAMERA)
    start = P.TransferFunction(ptf.lower, ptf.upper, torch.tensor(colors),
                               ptf.hg_g)
    params, plosses = pfit.fit_transfer_function(
        pv, pc, target, start, P.RenderConfig.from_json(cfg.to_json()),
        steps=2, learning_rate=1e-2, device="cpu")
    np.testing.assert_allclose(plosses, jlosses, rtol=GRAD_RTOL)
    assert plosses[1] < plosses[0]
    np.testing.assert_array_equal(params.tf_colors.detach()[:, :3].numpy(),
                                  colors[:, :3])


def _write_4d_nifti(path, data_cxyz, cal_max=0.0):
    """A NIfTI-1 file of a [C, X, Y, Z] float32 array, built as
    tests/test_multichannel.py:90-106 builds it (channel-major on disk)."""
    c, x, y, z = data_cxyz.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 4, x, y, z, c, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 124, cal_max)
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(b"\x00" * 4)
        f.write(np.ascontiguousarray(data_cxyz, np.float32).tobytes())


def test_4d_nifti_load(tmp_path):
    dims = (4, 5, 6, 3)
    data = np.arange(np.prod(dims), dtype=np.float32)
    path = tmp_path / "t4.nii"
    _write_4d_nifti(path, data.reshape(3, 4, 5, 6))
    pv = load_nifti(str(path), device="cpu")
    jv = jload_nifti(path, backend="python")
    assert (pv.dims, pv.channels) == (jv.dims, jv.channels) == ((4, 5, 6), 3)
    np.testing.assert_array_equal(pv.data.numpy(), np.asarray(jv.data))
    np.testing.assert_array_equal(pv.data[..., 0].numpy(),
                                  data.reshape(3, 4, 5, 6)[0])
    assert float(pv.cal_max) == float(jv.cal_max)


def test_cli_render_and_fit_4d(tmp_path):
    """``render`` and ``fit --data <4-D .nii>`` on the CPU, and ``render
    --conic``; the fit writes a TF whose rgb did not move."""
    rng = np.random.default_rng(2)
    path = str(tmp_path / "mc.nii")
    _write_4d_nifti(path, rng.uniform(0, 255, (3, 10, 11, 9)), cal_max=255.0)
    size = ["--width", "12", "--height", "10", "--spr", "16", "--device",
            "cpu", "--data", path]
    for flags in ([], ["--conic"]):
        out = str(tmp_path / f"mc{len(flags)}.png")
        assert cli.main(["render", *size, *flags, "--out", out]) == 0
    tf_out = str(tmp_path / "fit.txt")
    assert cli.main(["fit", *size, "--steps", "2", "--out-tf", tf_out]) == 0
    with open(tf_out) as f:
        fitted = from_text(f.read(), "cpu")
    start = P.default_transfer_function(device="cpu")
    assert torch.equal(fitted.colors[:, :3], start.colors[:, :3])


def test_a5_scan_matches_jax():
    """A 4-D a5 scan reads the volume's flat array as the JAX scan does
    (raycast.py:536), unlit and lit (channel 0's gradient)."""
    jv = _random_volume(3)
    jtf = J.default_transfer_function()
    pv, ptf, pc = _port(jv, jtf, CAMERA)
    for kw in ({}, dict(lighting=True)):
        cfg = CONFIG.replace(algorithm=J.Algorithm.TEST, **kw)
        want = np.asarray(jraycast.render_test(jv, jtf, CAMERA, cfg))
        got = P.render(pv, ptf, pc, P.RenderConfig.from_json(cfg.to_json()),
                       mode="scan", device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCAN)
        assert (np.abs(want[..., :3] - 0.2).max(-1) > 0.05).mean() > 0.05


def test_raises():
    """Scattering (the JAX package's reason, in every mode and in a fit),
    lit, LUT or smooth 4-D renders in fast mode (naming the scan), and 4-D
    fits beyond the ortho, unlit alpha-column fit in fast mode (naming the
    scan route, which fits them)."""
    pv = interop.volume_from_numpy(
        np.random.default_rng(1).uniform(0, 255, (6, 7, 5, 3)), 255.0,
        device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.Camera.initial(position=(0.3, 0.4, 0.9), device="cpu")
    cfg = P.RenderConfig(width=6, height=5, samples_per_ray=6)
    target = np.zeros((6, 5, 4), np.float32)
    for mode in ("fast", "scan"):
        with pytest.raises(NotImplementedError,
                           match="supports single-channel volumes"):
            P.render(pv, tf, cam, cfg.replace(scattering=True), mode=mode,
                     device="cpu")
    for kw in (dict(lighting=True), dict(tf_lut=64),
               dict(lighting=True, conic=True),
               dict(interp=Interp.TRILINEAR)):
        with pytest.raises(NotImplementedError, match="mode='scan'"):
            P.render(pv, tf, cam, cfg.replace(**kw), mode="fast",
                     device="cpu")
        assert P.render(pv, tf, cam, cfg.replace(**kw), mode="scan",
                        device="cpu").shape == (6, 5, 4)
    for kw, match in ((dict(scattering=True), "single-channel"),
                      (dict(conic=True), "mode='scan'"),
                      (dict(lighting=True), "mode='scan'"),
                      (dict(tf_lut=64), "mode='scan'"),
                      (dict(interp=Interp.TRILINEAR), "mode='scan'"),
                      (dict(algorithm=Algorithm.TEST), "mode='scan'")):
        with pytest.raises(NotImplementedError, match=match):
            pfit.fit_transfer_function(pv, cam, target, tf, cfg.replace(**kw),
                                       steps=1, device="cpu", mode="fast")
        if kw.get("scattering"):  # the JAX package's reason, in every mode
            with pytest.raises(NotImplementedError, match=match):
                pfit.fit_transfer_function(pv, cam, target, tf,
                                           cfg.replace(**kw), steps=1,
                                           device="cpu", mode="scan")
            continue
        _, losses = pfit.fit_transfer_function(
            pv, cam, target, tf, cfg.replace(**kw), steps=1, device="cpu",
            mode="scan")
        assert np.isfinite(losses[0])
    light = phong.default_light(device="cpu")
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        pfit.fit_transfer_function(pv, cam, target, tf, cfg, steps=1,
                                   device="cpu", light=light, mode="fast")
    _, losses = pfit.fit_transfer_function(pv, cam, target, tf, cfg, steps=1,
                                           device="cpu", light=light,
                                           mode="scan")
    assert np.isfinite(losses[0])
