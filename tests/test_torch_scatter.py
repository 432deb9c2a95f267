"""Single scattering (``config.scattering``) in the port against the JAX
package: the Henyey-Greenstein phase, the light-transmittance sweep, the
scatter bake, the plain scans (a1 ortho, conic, lit, LUT, smooth; a5) and
the fused marches' plain versions (``march_plain``, ``march_a5_plain``: the
CUDA kernels' arithmetic) against the Pallas kernels in interpret mode.
The scattered fit is tests/test_torch_scatter_fit.py's.  The CUDA kernels
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
from volumerenderingproject_tpu.ops import pallas_a5 as jpa5
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import phong as jphong

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import a5, march, phong
from volumerenderingproject_tpu_torch.utils.config import Algorithm

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL_GRID = 1e-6  # transmittance sweep, bake: one float order, ulps apart
TOL_SCAN = 2e-5  # scattered scans and plain versions vs JAX
HG = [0.0, 0.7, -0.3, 0.5]  # test_scatter_fused_hg_g's materials
# the JAX sweep jitted once (op by op, its lax.switch compiles every call)
_jax_sweep = jax.jit(jphong.light_transmittance_grid)


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


def _with_hg(jtf, hg):
    return dataclasses.replace(jtf, hg_g=jnp.asarray(hg, jnp.float32))


@pytest.fixture(scope="module")
def scene():
    """A small volume with negative voxels and cal_max 200.9, so trunc and
    float normalisations differ, every default-TF interval present, and a
    camera whose rays cross it and the empty space around it."""
    rng = np.random.default_rng(5)
    jv = J.make_volume(rng.uniform(-30.0, 255.0, (9, 11, 10))
                       .astype(np.float32), cal_max=200.9)
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=12, height=10, samples_per_ray=20)
    target = rng.uniform(0.0, 1.0, (12, 10, 4)).astype(np.float32)
    return jv, J.default_transfer_function(), jc, cfg, target


def test_henyey_greenstein_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.uniform(-1.0, 1.0, 200).astype(np.float32)
    g = rng.uniform(-0.95, 0.95, 200).astype(np.float32)
    c[:3], g[:3] = 1.0, np.float32([0.0, 1.0, -1.0])  # isotropic, clamped
    want = np.asarray(jphong.henyey_greenstein(jnp.asarray(c), jnp.asarray(g)))
    got = phong.henyey_greenstein(torch.tensor(c), torch.tensor(g)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[0], 1.0 / (4.0 * np.pi), rtol=1e-6)


def test_random_directions_unit_norm():
    gen = torch.Generator().manual_seed(3)
    v = phong.random_directions(gen, 500, device="cpu")
    assert v.shape == (500, 3) and v.dtype == torch.float32
    np.testing.assert_allclose(v.norm(dim=-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("direction", [
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (0.7, -0.5, 0.3), (0.5, 1.0, 0.75)])
def test_transmittance_grid_matches_jax(direction):
    """All six (axis, sign) sweeps and two oblique lights (the second the
    default light's direction), on a volume of three different extents."""
    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.0, 0.6, (7, 9, 8)).astype(np.float32)
    alpha[2, 3, 4] = 1.0  # an opaque voxel: att = 1e-9^dl
    d = np.asarray(direction, np.float32) * np.float32(1.3)
    want = np.asarray(_jax_sweep(jnp.asarray(alpha), jnp.asarray(d)))
    got = phong.light_transmittance_grid(torch.tensor(alpha),
                                         torch.tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRID)


def test_transmittance_grid_differentiable():
    """Gradients in alpha and in the light direction against jax.grad."""
    rng = np.random.default_rng(2)
    alpha = rng.uniform(0.0, 0.6, (6, 5, 7)).astype(np.float32)
    d = np.float32([0.4, -0.9, 0.3])
    w = rng.normal(size=(6, 5, 7)).astype(np.float32)

    def jloss(a, u):
        return jnp.sum(jphong.light_transmittance_grid(a, u) * w)

    ja, jd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(alpha),
                                             jnp.asarray(d))
    pa = torch.tensor(alpha, requires_grad=True)
    pd = torch.tensor(d, requires_grad=True)
    (phong.light_transmittance_grid(pa, pd) * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(pa.grad.numpy(), np.asarray(ja), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(pd.grad.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("alg", ["a1", "a5"])
def test_bake_scatter_grid_matches_jax(scene, alg):
    """a1 normalises the material lookup by trunc(cal_max), a5 by the float
    cal_max; the transmittance's alpha by trunc on both."""
    jv, jtf, jc, cfg, _ = scene
    jtf = _with_hg(jtf, HG)
    cfg = cfg.replace(scattering=True, scattering_strength=1.5,
                      density_scale=0.7)
    cal = jnp.asarray(jv.cal_max, jnp.float32)
    cal_g = jnp.trunc(cal) if alg == "a1" else cal
    lg = jphong.Light(direction=jnp.asarray([-0.3, 0.8, 0.4], jnp.float32),
                      color=jnp.full((3,), 0.9, jnp.float32),
                      ambient=jnp.float32(0.3), diffuse=jnp.float32(0.5),
                      specular=jnp.float32(0.2), shininess=jnp.float32(8.0))
    want = np.asarray(jpm.bake_scatter_grid(
        jv.data.reshape(jv.dims), jtf, cfg, lg, jc.front, cal_g,
        jnp.trunc(cal)))
    pv, ptf, pc = _port(jv, jtf, jc)
    pl = interop.light_from_numpy(*(np.asarray(getattr(lg, k)) for k in (
        "direction", "color", "ambient", "diffuse", "specular",
        "shininess")), device="cpu")
    pcal = pv.cal_max.to(torch.float32)
    got = phong.bake_scatter_grid(
        pv.data, ptf, P.RenderConfig.from_json(cfg.to_json()), pl, pc.front,
        torch.trunc(pcal) if alg == "a1" else pcal, torch.trunc(pcal)).numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_GRID)


SCAN_CASES = [
    (Algorithm.VRC, dict()),
    (Algorithm.VRC, dict(conic=True)),
    (Algorithm.VRC, dict(lighting=True)),
    (Algorithm.VRC, dict(tf_lut=64, density_scale=0.6)),
    (Algorithm.TEST, dict()),
    (Algorithm.VRC, dict(interp=J.Interp.TRILINEAR)),
]


@pytest.mark.parametrize("alg,kw", SCAN_CASES)
def test_scattered_scan_matches_jax(scene, alg, kw):
    """The port's front-to-back scan against the JAX scan, with the fused
    test's materials and strength 1.5."""
    jv, jtf, jc, cfg, _ = scene
    jtf = _with_hg(jtf, HG)
    kw = {k: (J.Interp[v.name] if k == "interp" else v) for k, v in kw.items()}
    cfg = cfg.replace(scattering=True, scattering_strength=1.5,
                      algorithm=J.Algorithm[alg.name], **kw)
    jfn = jraycast.render_test if alg is Algorithm.TEST else jraycast.render_vrc
    want = np.asarray(jfn(jv, jtf, jc, cfg, mode="fast"))
    unscattered = np.asarray(jfn(jv, jtf, jc, cfg.replace(scattering=False),
                                 mode="fast"))
    assert np.abs(want - unscattered).max() > 1e-3
    pv, ptf, pc = _port(jv, jtf, jc)
    got = P.render(pv, ptf, pc, P.RenderConfig.from_json(cfg.to_json()),
                   mode="scan", device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_SCAN)


@pytest.mark.parametrize("alg,kw,hg", [
    (Algorithm.VRC, dict(lighting=True), None),
    (Algorithm.VRC, dict(tf_lut=64), None),
    (Algorithm.VRC, dict(), HG),
    (Algorithm.TEST, dict(), HG),
])
def test_fused_plain_matches_pallas(scene, alg, kw, hg):
    """``march_plain``/``march_a5_plain`` on the baked (M, S) against the
    Pallas kernels in interpret mode (test_scatter_fused_kernels_match_xla,
    test_scatter_fused_hg_g), eps 0."""
    jv, jtf, jc, cfg, _ = scene
    if hg is not None:
        jtf = _with_hg(jtf, hg)
    cfg = cfg.replace(scattering=True, scattering_strength=1.5,
                      algorithm=J.Algorithm[alg.name], **kw)
    if alg is Algorithm.TEST:
        want = jpa5.render_test_pallas(jv, jtf, jc, cfg, early_eps=0.0,
                                       interpret=True)
    else:
        want = jpm.render_vrc_pallas(jv, jtf, jc, cfg, early_eps=0.0,
                                     interpret=True)
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    if alg is Algorithm.TEST:
        args = a5.prepare_a5(pv, ptf, pc, pcfg, 0.0)
        got = a5.march_a5_plain(args)
    else:
        args = march.prepare(pv, ptf, pc, pcfg, 0.0)
        got = march.march_plain(args)
    assert args.mgrid is not None and args.sgrid is not None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_SCAN)
    # render() takes the same plain version on the CPU
    np.testing.assert_array_equal(
        P.render(pv, ptf, pc, pcfg.replace(early_termination=0.0),
                 device="cpu").numpy(), got.numpy())
