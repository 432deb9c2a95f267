"""Port parity, sampling and the fused march module (ops/march.py): the
nearest-voxel index, the prep steps, and the kernel's plain version against
the JAX Pallas kernel run in interpret mode.  The CUDA kernel itself is
held against ``march_plain`` on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.ops import sampling as jsampling

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import march
from volumerenderingproject_tpu_torch.ops import sampling as psampling
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL = 2e-5  # kernel-level tolerance (benchmarks/onchip_parity.py)
TOL_EPS = 1.1e-3  # early termination at eps = 1e-3: <= eps * max colour


def _port(jv, jtf, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors", "hg_g")),
        device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc


@pytest.fixture(scope="module")
def scene():
    """The small scene of benchmarks/onchip_parity.py:66-74."""
    rng = np.random.default_rng(9)
    jv = J.make_volume(rng.uniform(-30, 255, (12, 14, 100)).astype(np.float32))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=32, height=32, samples_per_ray=24)
    return jv, jtf, jc, cfg


@pytest.mark.parametrize("dims", [(12, 14, 100), (182, 218, 182), (5, 9, 3)])
def test_octree_nn_index_exact(dims):
    rng = np.random.default_rng(17)
    depth = int(np.ceil(np.log2(max(dims))))  # Volume.octree_depth
    n = 2**depth
    k = rng.integers(-2, n + 2, (600, 3)).astype(np.float32)
    dyadic = (k / np.float32(n)).astype(np.float32)
    p = np.concatenate([
        rng.uniform(-0.1, 1.1, (3000, 3)).astype(np.float32),
        dyadic,
        np.nextafter(dyadic, np.float32(-1)),
        np.nextafter(dyadic, np.float32(2)),
    ])
    jflat, jvalid = jsampling.octree_nn_index(dims, depth, p)
    pflat, pvalid = psampling.octree_nn_index(dims, depth, torch.from_numpy(p))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(pflat.numpy(), np.asarray(jflat))
    vol = rng.uniform(-30, 255, dims).astype(np.float32)
    np.testing.assert_array_equal(
        psampling.octree_nn_sample(torch.from_numpy(vol).reshape(-1), dims,
                                   depth, torch.from_numpy(p)).numpy(),
        np.asarray(jsampling.octree_nn_sample(vol.reshape(-1), dims, depth, p)))


def _unpack_material_grid(grid, dims, zpack):
    """[X, Y, Z] ids from pack_material_grid's 4-bit rows."""
    d1, d2, d3 = dims
    zw, ypack, nyg = zpack
    grid = np.asarray(grid).view(np.uint32)
    x, y, z = np.meshgrid(np.arange(d1), np.arange(d2), np.arange(d3),
                          indexing="ij")
    rows = x * nyg + y // ypack
    lanes = (y % ypack) * zw + z // 8
    return (grid[rows, lanes] >> (4 * (z % 8)).astype(np.uint32)) & 15


@pytest.mark.parametrize("case", ["random", "bounds", "negative_cal"])
def test_material_ids_and_bricks_exact(case):
    rng = np.random.default_rng(3)
    dims = (13, 17, 20)
    jtf = J.default_transfer_function()
    cal = 255.0
    if case == "random":
        data = rng.uniform(-30, 255, dims)
    elif case == "bounds":  # intensities exactly on the interval bounds
        edges = np.concatenate([np.asarray(jtf.lower), np.asarray(jtf.upper)])
        data = rng.choice(np.concatenate([edges * 255.0, [0.0, 255.0]]), dims)
    else:  # cal_max truncates: 200.9 -> 200
        data = rng.uniform(-30, 230, dims)
        cal = 200.9
    jv = J.make_volume(data.astype(np.float32), cal_max=cal)
    pv, ptf, _ = _port(jv, jtf, J.reset_preset())
    cal_trunc = np.trunc(np.asarray(jv.cal_max))
    zpack = jpm.packed_geometry(jv.dims, jtf.num_intervals)
    grid, jid0 = jpm.pack_material_grid(jv, jtf, cal_trunc, zpack)
    ids, id0 = march.material_ids(pv.data, ptf, torch.trunc(pv.cal_max))
    assert ids.dtype == torch.uint8
    np.testing.assert_array_equal(ids.numpy(),
                                  _unpack_material_grid(grid, dims, zpack))
    assert int(id0) == int(jid0)
    jocc, jnb = jpm.brick_occupancy(jv, jtf, cal_trunc)
    occ, nb = march.brick_occupancy(ids, ptf)
    assert nb == jnb
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


@pytest.mark.parametrize("conic", [False, True])
def test_march_plain_matches_pallas_interpret(scene, conic):
    jv, jtf, jc, cfg = scene
    cfg = cfg.replace(conic=conic)
    want = np.asarray(jpm.render_vrc_pallas(jv, jtf, jc, cfg, early_eps=0.0,
                                            interpret=True))
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    got = march.march_plain(march.prepare(pv, ptf, pc, pcfg, 0.0)).numpy()
    assert got.shape == want.shape == (32, 32, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_march_plain_early_termination_bound():
    """A dense scene whose rays do terminate: eps = 1e-3 stays within
    1.1e-3 of the exact (eps = 0) Pallas render, and does cut rays."""
    rng = np.random.default_rng(8)
    jv = J.make_volume(rng.uniform(100, 125, (12, 14, 40)).astype(np.float32))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=32, height=32, samples_per_ray=48)
    exact = np.asarray(jpm.render_vrc_pallas(jv, jtf, jc, cfg, early_eps=0.0,
                                             interpret=True))
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    early = march.march_plain(march.prepare(pv, ptf, pc, pcfg, 1e-3)).numpy()
    full = march.march_plain(march.prepare(pv, ptf, pc, pcfg, 0.0)).numpy()
    np.testing.assert_allclose(full, exact, rtol=0, atol=TOL)
    np.testing.assert_allclose(early, exact, rtol=0, atol=TOL_EPS)
    assert np.abs(early - full).max() > 0.0  # some rays stopped early


def test_march_plain_counts_needed_samples(scene):
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json())
    stats = {}
    march.march_plain(march.prepare(pv, ptf, pc, pcfg, 0.0), stats)
    assert 0 < stats["samples"] <= 32 * 32 * 24


def test_scal_vector_layout(scene):
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    pcfg = RenderConfig.from_json(cfg.to_json()).replace(conic=True)
    a = march.prepare(pv, ptf, pc, pcfg, 1e-3)
    jscal = np.asarray(jpm._scal_vector(
        jc, cfg.replace(conic=True), np.trunc(np.float32(255.0)),
        np.float32(1e-3), np.float32(0.0),
        *[[np.float32(v) for v in b] for b in march._box(jv.dims, jv.octree_depth)],
        np.float32(0.0), 0, 0, 0))
    s = a.scal.numpy()
    assert s.shape == (march.SCAL_LEN,)
    np.testing.assert_array_equal(s[:28], jscal[:28])  # shared slots
    assert s[march.S_ID0] == 0.0
    np.testing.assert_array_equal(s[march.S_BG:march.S_BG + 3],
                                  np.float32(cfg.background[:3]))


def test_kernel_wrapper_refuses_cpu_tensors(scene):
    """No fallback: the kernel wrapper launches on CUDA or raises."""
    jv, jtf, jc, cfg = scene
    pv, ptf, pc = _port(jv, jtf, jc)
    a = march.prepare(pv, ptf, pc, RenderConfig.from_json(cfg.to_json()), 0.0)
    before = march.launches
    with pytest.raises(ValueError, match="CUDA"):
        march.march_kernel(a)
    assert march.launches == before
