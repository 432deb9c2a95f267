"""Port parity of the lighting and LUT building blocks: the gradient
filters (``ops/conv3d.py``), Blinn-Phong (``ops/phong.py``), the dense TF
LUT, the LUT-index grid, the baked (M, S) factors (``ops/march.py``) and
``interop.light_from_numpy``, each against the JAX package on the same
seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ops import conv3d as jconv
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import phong as jphong
from volumerenderingproject_tpu.scene import transfer_function as jtfm

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import conv3d, march, phong
from volumerenderingproject_tpu_torch.scene import transfer_function as ptfm
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
TOL_SHADE = 1e-6  # phong_shade and the bakes: pow and the norms by ulps


def _volume(seed=3, dims=(13, 17, 20)):
    return np.random.default_rng(seed).uniform(-30, 255, dims).astype(
        np.float32)


def _port_light(jl, device="cpu"):
    return interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS), device=device)


def _jax_light(seed):
    rng = np.random.default_rng(seed)
    return jphong.Light(
        direction=np.asarray(rng.normal(size=3), np.float32),
        color=np.full(3, rng.uniform(0.5, 1.5), np.float32),
        ambient=np.float32(rng.uniform(0.1, 0.5)),
        diffuse=np.float32(rng.uniform(0.3, 0.8)),
        specular=np.float32(rng.uniform(0.1, 0.5)),
        shininess=np.float32(rng.uniform(2.0, 40.0)))


@pytest.mark.parametrize("filt,sigma", [("central", 0.0), ("sobel", 0.0),
                                        ("central", 1.0)])
def test_gradient_field_exact(filt, sigma):
    """The same taps added in the same order: bit-equal to XLA's CPU
    result (no ulp of slack is needed)."""
    vol = _volume()
    want = np.asarray(jconv.gradient_field(vol, filt, sigma))
    got = conv3d.gradient_field(torch.from_numpy(vol), filt, sigma).numpy()
    assert got.shape == want.shape == vol.shape + (3,)
    np.testing.assert_array_equal(got, want)


def test_gaussian_kernel_and_smooth_exact():
    vol = _volume(4, (9, 11, 7))
    np.testing.assert_array_equal(conv3d.gaussian_kernel1d(1.3).numpy(),
                                  np.asarray(jconv.gaussian_kernel1d(1.3)))
    np.testing.assert_array_equal(
        conv3d.gaussian_smooth(torch.from_numpy(vol), 0.8).numpy(),
        np.asarray(jconv.gaussian_smooth(vol, 0.8)))
    with pytest.raises(ValueError, match="gradient_filter"):
        conv3d.gradient_field(torch.from_numpy(vol), "prewitt")


def test_default_light_and_vec_round_trip():
    jl = jphong.default_light()
    pl = phong.default_light(device="cpu")
    for k in LIGHT_FIELDS:
        np.testing.assert_array_equal(getattr(pl, k).numpy(),
                                      np.asarray(getattr(jl, k)))
    v = phong.light_to_vec(pl)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jphong.light_to_vec(jl)))
    back = phong.light_from_vec(v)
    for k in LIGHT_FIELDS:
        assert torch.equal(getattr(back, k), getattr(pl, k))


@pytest.mark.parametrize("light_seed", [None, 11])
def test_phong_shade_matches_jax(light_seed):
    rng = np.random.default_rng(5)
    rgb = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    normal = rng.normal(size=(300, 3)).astype(np.float32)
    normal[:40] *= np.float32(1e-4)  # below the threshold: fades to rgb
    normal[40:50] = 0.0
    view = rng.normal(size=(300, 3)).astype(np.float32)
    jl = jphong.default_light() if light_seed is None else _jax_light(
        light_seed)
    want = np.asarray(jphong.phong_shade(rgb, normal, view, jl))
    got = phong.phong_shade(torch.from_numpy(rgb), torch.from_numpy(normal),
                            torch.from_numpy(view), _port_light(jl)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SHADE)
    np.testing.assert_array_equal(got[40:50], rgb[40:50])


def test_safe_pow_matches_jax():
    base = np.asarray([0.0, 1e-7, 1e-6, 0.3, 1.0], np.float32)
    np.testing.assert_allclose(
        phong.safe_pow(torch.from_numpy(base), torch.tensor(16.0)).numpy(),
        np.asarray(jphong.safe_pow(base, np.float32(16.0))), rtol=1e-6,
        atol=0)


@pytest.mark.parametrize("resolution", [2, 64, 255, 256, 1000, 1024])
def test_to_lut_bit_equal(resolution):
    jtf = J.default_transfer_function()
    ptf = ptfm.default_transfer_function(device="cpu")
    np.testing.assert_array_equal(ptf.to_lut(resolution).numpy(),
                                  np.asarray(jtf.to_lut(resolution)))


def test_to_lut_bound_on_a_grid_point():
    """A bound equal to a LUT grid point (as JAX computes the point) takes
    the interval's colour there, in both packages; the IEEE quotient
    i / (R - 1) would miss it."""
    pts = np.asarray(jnp.linspace(0.0, 1.0, 256, dtype=jnp.float32))
    lo = pts[3]
    assert lo != np.float32(3) / np.float32(255)  # a point where they differ
    text = (f"empty 0 1 0 0 0 0\n"
            f"edge {float(lo)!r} {float(pts[7])!r} 1 0 0 0.5\n")
    want = np.asarray(jtfm.from_text(text).to_lut(256))
    got = ptfm.from_text(text, device="cpu").to_lut(256).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3, 3] == np.float32(0.5) and got[2, 3] == 0.0


def test_lut_ids_and_bricks_match_pack_lut_grid():
    """The uint16 LUT-index grid against JAX's packed 16-bit grid, and the
    brick map through the LUT's alphas (cal_max 200.9 truncates)."""
    data = _volume(6)
    jv = J.make_volume(data, cal_max=200.9)
    n = 256
    cal = np.trunc(np.float32(200.9))
    zp = jpm.packed_lut_geometry(jv.dims, n)
    grid = np.asarray(jpm.pack_lut_grid(jv, n, cal, zp)).view(np.uint32)
    d1, d2, d3 = jv.dims
    zw, ypack, nyg = zp
    x, y, z = np.meshgrid(*map(np.arange, jv.dims), indexing="ij")
    want = (grid[x * nyg + y // ypack, (y % ypack) * zw + z // 2]
            >> (16 * (z % 2)).astype(np.uint32)) & 0xFFFF
    ids = march.lut_ids(torch.from_numpy(data), n, torch.tensor(cal))
    assert ids.dtype == torch.uint16
    np.testing.assert_array_equal(ids.numpy(), want)
    jtf = J.default_transfer_function()
    ptf = ptfm.default_transfer_function(device="cpu")
    lut = ptf.to_lut(n)
    jocc, jnb = jpm.brick_occupancy(jv, jtf, cal, lut=jtf.to_lut(n))
    occ, nb = march.brick_occupancy(ids, lut)
    assert nb == jnb
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    with pytest.raises(ValueError, match="tf_lut"):
        march.lut_ids(torch.from_numpy(data), 2048, torch.tensor(cal))


@pytest.mark.parametrize("filt,sigma,light_seed", [
    ("central", 0.0, None), ("sobel", 0.0, 11), ("central", 1.0, None)])
def test_bake_matches_jax(filt, sigma, light_seed):
    data = _volume(7)
    cfg = J.RenderConfig(gradient_filter=filt, presmooth_sigma=sigma)
    jl = jphong.default_light() if light_seed is None else _jax_light(
        light_seed)
    view = np.asarray([-0.3, 0.5, -0.8], np.float32)
    jm, js = jpm.bake_light_grids(data, cfg, jl, view)
    pm, ps = phong.bake_light_grids(
        torch.from_numpy(data), RenderConfig.from_json(cfg.to_json()),
        _port_light(jl), torch.from_numpy(view))
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0,
                               atol=TOL_SHADE)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=0,
                               atol=TOL_SHADE)


@pytest.mark.parametrize("scale", [0.1, 0.9, 1.0, 1.1, 10.0])
def test_bake_matches_phong_shade(scale):
    """The scan (phong_shade) and the fused marches' bake share one fade
    threshold: rgb * M + S equals the scan's shading for gradients around
    phong.GRAD_THRESHOLD (at ``scale`` times it)."""
    rng = np.random.default_rng(9)
    rgb = torch.from_numpy(rng.uniform(0, 1, (200, 3)).astype(np.float32))
    unit = rng.normal(size=(200, 3))
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    grad = torch.from_numpy(
        (unit * scale * phong.GRAD_THRESHOLD).astype(np.float32))
    light = _port_light(_jax_light(4))
    view = torch.tensor([-0.3, 0.5, -0.8])
    m, s = phong.bake_light_grids_from_grad(grad, light, view)
    want = phong.phong_shade(rgb, grad, view, light)
    np.testing.assert_allclose((rgb * m[:, None] + s[:, None]).numpy(),
                               want.numpy(), rtol=0, atol=TOL_SHADE)


def test_light_from_numpy_round_trip():
    jl = _jax_light(3)
    pl = _port_light(jl)
    for k in LIGHT_FIELDS:
        got = getattr(pl, k)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jl, k)))
    again = interop.light_from_numpy(
        *(getattr(pl, k).numpy() for k in LIGHT_FIELDS), device="cpu")
    for k in LIGHT_FIELDS:
        assert torch.equal(getattr(again, k), getattr(pl, k))
    moved = pl.to("cpu")
    assert torch.equal(moved.direction, pl.direction)
