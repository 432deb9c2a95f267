"""The a5 marches' hoisted position chain (csrc/a5_common.cuh).

K3 (csrc/a5.cu) and K6 (csrc/a5_bwd.cu) put sample i of the ray of pixel
(px, py) where the three stage matrices do (``ops/a5.apply_stages``,
kernel.cu:100-115), but by the TPU kernel's hoisted chain
(pallas_a5.py:186-215): per ray ``q_c = (px s1 + o1) iv[c][0] + (py s2 +
o2) iv[c][1]``, per sample ``p2_c = (q_c + (i s3) iv[c][2]) + iv[c][3]``
and ``p_c = p2_c L_c + m3_c``.  That is exact because prep
(``ops/a5.stage_matrices``) builds modelCam as a scale with a translation
and toVolume as the scale L with a translation, with zeros off their
diagonals: a product with such a zero adds a signed zero to a sum.  These
tests hold

- the structural zeros of modelCam and toVolume, on orbit cameras and odd
  shapes, and their entries against the scalars the JAX package's kernel
  reads (pallas_a5.py:1026-1037);
- the hoisted chain (``a5.ray_q``, ``a5.positions``, in the kernels' float
  order) bit-equal to ``apply_stages`` on every sample of every ray, on
  orbit cameras, a camera inside the volume, fronts along each axis, rays
  that miss, segment units of a (2, 2, 1) mesh and 512 samples a ray;
- and bit-equal to the JAX package's ``models/raycast._a5_positions`` on
  the CPU, given the JAX package's view inverse (the two packages' float32
  inverses differ by a few ulps, test_torch_a5.py), on the scenes of
  tests/test_pallas_a5.py.

The kernels read the scalar vector's slots; ``test_torch_a5.py``'s
``test_scal_vector_layout`` pins them.

The kernels also take 32-bit voxel indices where every flat index a corner
can form stays below 2^31 (``a5_index32``); ``a5.index32`` mirrors the rule
and is held here on both sides of the edge (chip_smoke.py holds the
kernel's rule to the mirror, and the 64-bit instances to the plain
versions on a grid past the edge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.utils import transforms as JT

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import a5
from volumerenderingproject_tpu_torch.utils.config import Algorithm

_f32 = np.float32


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _odd(shape=(13, 17, 20)):
    rng = np.random.default_rng(1)
    return P.make_volume(rng.uniform(-30, 255, shape).astype(np.float32),
                         cal_max=200.9, device="cpu")


def _cam(pos):
    return P.Camera.initial(position=pos, device="cpu")


# name -> (camera position, volume shape, (width, height, samples)[, view
# angle]); the deep volume's narrow screen covers its thin x and y extents
SCENES = {
    "orbit": ((1.5 * np.cos(0.7), 0.4, 1.5 * np.sin(0.7)), (13, 17, 20),
              (41, 29, 64)),
    "orbit_low": ((-1.2, -0.9, 0.5), (13, 17, 20), (41, 29, 64)),
    "near": ((0.35, 0.45, 0.85), (13, 17, 20), (61, 37, 37)),
    "inside": ((0.05, -0.1, 0.12), (13, 17, 20), (33, 25, 48)),
    "front_z": ((0.0, 0.0, 1.5), (13, 17, 20), (31, 23, 40)),
    "front_x": ((1.5, 0.0, 0.0), (13, 17, 20), (31, 23, 40)),
    "front_y": ((0.0, 1.5, 1e-3), (13, 17, 20), (31, 23, 40)),
    "miss": ((3.0, 2.5, -0.2), (13, 17, 20), (31, 23, 40)),
    "deep": ((0.004, 0.002, 1.5), (9, 11, 512), (17, 13, 512), 0.012),
}


def _config(name):
    _, _, (w, h, spr), *angle = SCENES[name]
    cfg = P.RenderConfig(width=w, height=h, samples_per_ray=spr,
                         algorithm=Algorithm.TEST)
    return cfg.replace(view_angle=angle[0]) if angle else cfg


def _args(name, **unit):
    pos, shape = SCENES[name][:2]
    cfg = _config(name)
    return a5.prepare_a5(_odd(shape), P.default_transfer_function(
        device="cpu"), _cam(pos), cfg, 0.0, **unit)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stage_matrices_have_structural_zeros(name):
    pos, shape = SCENES[name][:2]
    cfg = _config(name)
    mc, iv, tv = a5.stage_matrices(_cam(pos), shape, cfg)
    off = ~torch.eye(4, dtype=torch.bool)
    off[:3, 3] = False  # the translations
    assert (mc[off] == 0.0).all() and (tv[off] == 0.0).all()
    assert mc[2, 3] == 0.0  # modelCam moves no sample along its front
    assert (mc[3] == torch.tensor([0.0, 0.0, 0.0, 1.0])).all()
    assert (tv[3] == torch.tensor([0.0, 0.0, 0.0, 1.0])).all()
    # the scalars the JAX kernel reads (pallas_a5.py:1026-1037): the
    # Python doubles rounded once to float32
    L = float(max(shape))
    want_mc = [cfg.real_screen_width / cfg.width,
               cfg.real_screen_height / cfg.height,
               -cfg.viewplane_distance / cfg.samples_per_ray]
    assert [float(mc[k, k]) for k in range(3)] == [float(_f32(v))
                                                   for v in want_mc]
    assert float(mc[0, 3]) == float(_f32(-cfg.real_screen_width / 2.0))
    assert float(mc[1, 3]) == float(_f32(-cfg.real_screen_height / 2.0))
    assert [float(tv[k, k]) for k in range(3)] == [L] * 3
    assert [float(tv[k, 3]) for k in range(3)] == [
        float(_f32(d / 2.0 - L / 2.0 + 0.5 * L)) for d in shape]
    # the kernels read the rows from the scalar vector as prep lays them
    a = _args(name)
    for s, m in zip((a5.S_MC, a5.S_IV, a5.S_TV), (mc, iv, tv)):
        assert torch.equal(a.scal[s:s + 12], m[:3].reshape(-1))


def _check_every_sample(a):
    """The hoisted chain against apply_stages on every sample of every
    ray of ``a``'s unit -> the samples inside [0, dims)."""
    mats = a5._stage_rows(a)
    x = (torch.arange(a.width, dtype=torch.float32)
         + float(a.x_offset))[:, None].expand(a.width, a.height)
    y = torch.arange(a.height, dtype=torch.float32)[None, :].expand(
        a.width, a.height)
    q = a5.ray_q(a)
    dims = torch.tensor(a.dims, dtype=torch.float32)
    inside = 0
    for i in range(a.s_start, a.s_start + a.spr):
        want = a5.apply_stages(mats, x, y, torch.tensor(float(i)))
        got = a5.positions(a, q, i)
        assert torch.equal(_bits(got), _bits(want)), i
        inside += int(((want >= 0) & (want < dims)).all(-1).sum())
    return inside


@pytest.mark.parametrize("name", sorted(SCENES))
def test_hoisted_chain_is_apply_stages_on_every_sample(name):
    inside = _check_every_sample(_args(name))
    assert (inside == 0) == (name == "miss")


@pytest.mark.parametrize("unit", range(4))
def test_hoisted_chain_on_segment_units(unit):
    """The units of a (2, 2, 1) mesh of the orbit scene: global columns
    and sample indices (unit 2, the right columns' first samples, lies in
    front of the volume)."""
    _, _, (w, _, spr) = SCENES["orbit"]
    xr, sr = divmod(unit, 2)
    half_w, half_s = w // 2, spr // 2
    kw = dict(x_offset=xr * half_w,
              local_width=half_w if xr == 0 else w - half_w,
              s_start=sr * half_s,
              s_count=half_s if sr == 0 else spr - half_s, segment=True)
    assert (_check_every_sample(_args("orbit", **kw)) > 0) == (unit != 2)


JAX_SCENES = {  # tests/test_pallas_a5.py's cameras and shapes
    "random": ((10, 12, 11), (0.35, 0.45, 0.85), (20, 14, 40)),
    "z_wrap": ((6, 6, 6), (0.1, 0.2, 0.95), (16, 16, 24)),
    "packed": ((6, 6, 130), (0.1, 0.2, 0.95), (16, 16, 24)),
    "orbit": ((13, 17, 20), (1.5 * np.cos(0.7), 0.4, 1.5 * np.sin(0.7)),
              (21, 15, 30)),
}


@pytest.mark.parametrize("name", sorted(JAX_SCENES))
def test_hoisted_chain_is_the_jax_positions(name):
    shape, pos, (w, h, spr) = JAX_SCENES[name]
    rng = np.random.default_rng(11)
    jv = J.make_volume(rng.uniform(0, 255, shape).astype(np.float32))
    jc = J.Camera.initial(position=pos)
    cfg = J.RenderConfig(width=w, height=h, samples_per_ray=spr,
                         algorithm=J.Algorithm.TEST)
    pv = interop.volume_from_numpy(np.asarray(jv.data),
                                   np.asarray(jv.cal_max), jv.dims,
                                   device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in
          ("position", "front", "right", "up", "top_left")), device="cpu")
    pcfg = P.RenderConfig.from_json(cfg.to_json())
    a = a5.prepare_a5(pv, P.default_transfer_function(device="cpu"), pc,
                      pcfg, 0.0)
    # the JAX package's view inverse in the inverseView slots
    jiv = torch.from_numpy(np.asarray(
        JT.inverse(jc.look_at_origin_view()))[:3].reshape(-1).copy())
    scal = a.scal.clone()
    scal[a5.S_IV:a5.S_IV + 12] = jiv
    a = a._replace(scal=scal)
    x, y = jraycast.pixel_grid(cfg)
    q = a5.ray_q(a)
    for i in range(spr):
        want = np.asarray(jraycast._a5_positions(x, y, jnp.float32(i), jc,
                                                 jv, cfg))
        got = a5.positions(a, q, i).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


# the index width (a5.index32, the mirror of a5_index32): a corner index
# reaches dim + 1, and the flat index's row and plane wraps one more row
# and plane, so (d1 + 1) d2 d3 + (d2 + 1) d3 + d3 + 1 must stay below 2^31
EDGE = 2**31


def test_a_corner_index_reaches_dim_plus_one():
    """trunc(p + 1) of the float just below a power-of-two dim is dim + 1
    (p + 1 is a tie that rounds to even), so the rule counts dim + 1."""
    for dim in (64, 1024, 2048):
        p = np.nextafter(_f32(dim), _f32(0))
        assert p < dim and np.trunc(p + _f32(1)) == dim + 1


@pytest.mark.parametrize("case, dims", [
    ("line_last_below", (EDGE - 6, 1, 1)),
    ("line_at_edge", (EDGE - 5, 1, 1)),
    # 1290 (1289^2 + 1290) < 2^31 <= 1291 (1290^2 + 1291)
    ("cube_1289", (1289, 1289, 1289)),
    ("cube_1290", (1290, 1290, 1290)),
    # one plane: 2^15 (3 d2 + 2) + 1, the wraps a third of it
    ("plane_last_below", (1, 21844, 2**15)),
    ("plane_at_edge", (1, 21845, 2**15)),
])
def test_index_width_at_the_edge(case, dims):
    d1, d2, d3 = dims
    want = (d1 + 1) * d2 * d3 + (d2 + 1) * d3 + d3 + 1 <= EDGE - 1
    assert a5.index32(dims) == want
    assert want == (case.endswith("below") or case == "cube_1289")


def test_index_width_of_the_main_paths():
    """MNI-dims, the a5 lit 300^3 row, 320^3 and 512^3 take 32 bits."""
    for dims in ((182, 218, 182), (300, 300, 300), (320, 320, 320),
                 (512, 512, 512), (1024, 1024, 1024)):
        assert a5.index32(dims)
