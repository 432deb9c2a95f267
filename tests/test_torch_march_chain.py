"""The a1 marches' voxel chain without a division (csrc/march_common.cuh).

K1 (csrc/march.cu) and K4 (csrc/march_bwd.cu) put sample i of a ray in
its voxel by the chain of ``VRP_SAMPLE_VOXEL`` and ``sample_voxel_slab``:
``res = (floorf(p n) / n) L`` with n = 2^depth, as the JAX package
(pallas_march.py:461) and the port's plain versions (``ops/march``
``_sample_ids``) compute it; K1's brick test (``chunk_occupied``) pushes
the ends of a run of samples through the same quotient.  The kernels take
``floorf(p n) * inv_n`` instead, inv_n = 1 / n held in ``Geom``.  The
quotient of an integer-valued float (or of a zero, an infinity or a NaN)
by a power of two is exact, so the product is the same float bit for bit;
these tests hold the two against each other:

- on the float32 inputs where rounding would show first: every multiple
  k / n of the leaf (all of them up to depth 11, a seeded 4096 beyond)
  and the four floats on each side of it, over [-1, 2), plus signed zeros,
  infinities, NaN, negatives, 1 - 2^-24 and the smallest subnormal, for
  depths 0 to 30, in numpy and in torch;
- on whole scenes: every sample of every ray (``march._rays``, the
  kernels' ray setup) gets the same voxel indices, validity, flat index
  and, on an x-slab, ownership code (-2 another slab's, -1 owned off the
  volume, else the slab-local flat index) from the chain computed both
  ways, on an ortho orbit and a conic camera over an odd 13x17x20 volume,
  the units of a (1, 2, 2) mesh, and rays within 1e-7 of parallel to a
  face (``chip_smoke.near_parallel_args``).  The chain computed with the
  division is held to ``march._sample_ids`` first, so the test's chain is
  the port's.

K1 also takes 32-bit voxel indices where they cannot overflow
(``vrp_march_a1_index32``); ``march.index32`` mirrors the rule and is held
here on both sides of the 2^31 edge (chip_smoke.py holds the kernel's rule
to the mirror, and the 64-bit instances to the plain version on grids past
the edge).

No JAX: the plain versions are held to the JAX package elsewhere
(``test_torch_march.py``), the kernels to the plain versions on the card
(chip_smoke.py)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.ops import march
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

_f32 = np.float32
DEPTHS = range(31)
ULPS = 4  # floats on each side of every k / n
ALL_K_UP_TO = 2048  # every leaf multiple while n <= this, else a sample
SAMPLED_K = 4096
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, -0.5, -1e-30,
                     1.0 - 2.0 ** -24, 1.0, 0.5, 1e-45, -1e-45, 3e38, -3e38],
                    dtype=_f32)


def _inputs(depth: int) -> np.ndarray:
    """float32 p: the leaf multiples k / 2^depth over [-1, 2), each with
    the ULPS floats on either side, and SPECIALS."""
    n = 2 ** depth
    if n <= ALL_K_UP_TO:
        ks = np.arange(-n, 2 * n + 1, dtype=np.float64)
    else:
        rng = np.random.default_rng(depth)
        ks = np.concatenate([rng.integers(-n, 2 * n, SAMPLED_K),
                             [-n, -1, 0, 1, n - 1, n, n + 1, 2 * n]]
                            ).astype(np.float64)
    centre = (ks / n).astype(_f32)
    out = [centre]
    up, down = centre.copy(), centre.copy()
    for _ in range(ULPS):
        up = np.nextafter(up, _f32(np.inf))
        down = np.nextafter(down, _f32(-np.inf))
        out += [up, down]
    return np.concatenate(out + [SPECIALS])


@pytest.mark.parametrize("depth", DEPTHS)
def test_floor_quotient_is_the_reciprocal_product(depth):
    p = _inputs(depth)
    n = _f32(2 ** depth)
    inv_n = _f32(1) / n  # Geom::inv_n
    assert inv_n * n == _f32(1)
    with np.errstate(invalid="ignore", over="ignore"):
        q = np.floor(p * n)
        quot, prod = q / n, q * inv_n
    assert quot.dtype == prod.dtype == np.float32
    assert np.array_equal(quot.view(np.uint32), prod.view(np.uint32))
    # torch, as the plain versions compute it
    qt = torch.floor(torch.from_numpy(p) * float(n))
    tquot = qt / torch.tensor(n)
    tprod = qt * torch.tensor(inv_n)
    assert torch.equal(tquot.view(torch.int32), tprod.view(torch.int32))
    assert np.array_equal(tquot.numpy().view(np.uint32), quot.view(np.uint32))


def _chain(a: march.MarchArgs, o, d, i: int, reciprocal: bool):
    """Sample i of rays ``o``, ``d`` through the kernels' chain
    (VRP_SAMPLE_VOXEL and sample_voxel_slab) in float32, dividing by n or
    multiplying by 1 / n -> (ijk int64 [W, H, 3], valid [W, H], flat of the
    whole grid, clamped [W, H], slab code [W, H])."""
    dims = a.dims
    L = _f32(max(dims))
    n = _f32(2 ** a.depth)
    inv_n = _f32(1) / n
    halfL = L * _f32(0.5)
    halfd = torch.tensor([_f32(v) * _f32(0.5) for v in dims])
    hg = torch.tensor([halfL - _f32(v) * _f32(0.5) for v in dims])
    hg_hi = hg + torch.tensor(dims, dtype=torch.float32)
    s = a.scal
    ti = torch.tensor(_f32(i)) * s[march.S_DS] + s[march.S_CLIP]
    p = (o + ti * d) + 0.5
    q = torch.floor(p * torch.tensor(n))
    res = (q * torch.tensor(inv_n) if reciprocal else q / torch.tensor(n)) * L
    valid = ((p >= 0.0) & (p < 1.0) & (res >= hg) & (res < hg_hi)).all(-1)
    ijk = torch.trunc((res + halfd) - halfL).to(torch.int64)
    d1, d2, d3 = dims
    flat = ((ijk[..., 0] * d2 + ijk[..., 1]) * d3 + ijk[..., 2]).clamp(
        0, d1 * d2 * d3 - 1)
    x0, nx = (a.x0, a.slab_x) if a.slab_x else (0, d1)
    gx = ijk[..., 0].clamp(0, d1 - 1)
    owned = (gx >= x0) & (gx < x0 + nx)
    local = (((ijk[..., 0] - x0) * d2 + ijk[..., 1]) * d3
             + ijk[..., 2]).clamp(0, nx * d2 * d3 - 1)
    code = torch.where(owned, torch.where(valid, local, -1), -2)
    return ijk, valid, flat, code


def _odd(shape=(13, 17, 20)):
    rng = np.random.default_rng(1)
    return P.make_volume(rng.uniform(-30, 255, shape).astype(np.float32),
                         cal_max=200.9, device="cpu")


def _near_parallel_args():
    """chip_smoke.near_parallel_args, loaded from the repository root."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.near_parallel_args


SMALL = RenderConfig(width=61, height=37, samples_per_ray=37)
ORBIT = (1.5 * np.cos(0.7), 0.4 + 0.2 * np.sin(1.4), 1.5 * np.sin(0.7))
NEAR = (0.35, 0.45, 0.85)


def _scene(name):
    """The march input of scene ``name``."""
    tf = P.default_transfer_function(device="cpu")

    def cam(pos):
        return P.Camera.initial(position=pos, device="cpu")

    if name == "odd_ortho_orbit":
        return march.prepare(_odd(), tf, cam(ORBIT), SMALL, 0.0)
    if name == "odd_conic":
        return march.prepare(_odd(), tf, cam(NEAR), SMALL.replace(conic=True),
                             0.0)
    if name.startswith("slab_unit"):  # the units of a (1, 2, 2) mesh
        v = int(name[-1])
        s = int(name[-3])
        vol = _odd((14, 17, 20))
        cfg = SMALL.replace(samples_per_ray=40)
        return march.prepare(vol, tf, cam(ORBIT), cfg, 0.0, s_start=20 * s,
                             s_count=20, x0=7 * v, slab_x=7, segment=True)
    face, side = int(name[-3]), int(name[-1])  # near_parallel_<face>_<side>
    a = march.prepare(_odd(), tf, cam(NEAR), SMALL, 0.0)
    return _near_parallel_args()(march, a, face, side, 1e-7)


SCENES = (["odd_ortho_orbit", "odd_conic"]
          + [f"slab_unit_{s}_{v}" for s in (0, 1) for v in (0, 1)]
          + [f"near_parallel_{f}_{s}" for f in (0, 1) for s in (0, 1)])


@pytest.mark.parametrize("name", SCENES)
def test_chain_without_division_on_every_sample(name):
    a = _scene(name)
    o, d = march._rays(a, a.x_offset, a.full_width)
    ids_at = march._sample_ids(a, o, d)
    inside = 0
    for i in range(a.s_start, a.s_start + a.spr):
        ijk, valid, flat, code = _chain(a, o, d, i, reciprocal=False)
        # the test's chain is the port's (the plain versions' _sample_ids)
        _, valid_p, flat_p, ijk_p = ids_at(i)
        assert torch.equal(ijk, ijk_p)
        if a.slab_x:
            assert torch.equal(valid_p, code >= 0)
            assert torch.equal(flat_p[valid_p], code[valid_p])
        else:
            assert torch.equal(valid_p, valid)
            assert torch.equal(flat_p[valid], flat[valid])
        got = _chain(a, o, d, i, reciprocal=True)
        for x, y in zip((ijk, valid, flat, code), got):
            assert torch.equal(x, y)
        inside += int(valid.sum())
    assert inside > 0  # the scene reaches the volume


# K1's index width (ops/march.index32, the mirror of vrp_march_a1_index32
# in csrc/march.cu, which chip_smoke.py holds to it on the card): the
# largest grid times its channels, plus a plane and a row, below 2^31
EDGE = 2**31


def _sized(dims, slab_x=0, chans=0, lit=False):
    """A march input whose index width reads ``dims``, the slab, the
    channel grids and the in-kernel light's volume (only their shapes and
    presence matter: the grids stay small)."""
    a = _scene("odd_ortho_orbit")
    return a._replace(
        dims=dims, slab_x=slab_x,
        chans=torch.zeros((chans, 1, 1, 1)) if chans else None,
        vol=torch.zeros(1) if lit else None)


@pytest.mark.parametrize("case, dims, kw", [
    # every flat index just below 2^31, then just at it: d1 + 1 + 1
    ("plain_last_below", (EDGE - 3, 1, 1), {}),
    ("plain_at_edge", (EDGE - 2, 1, 1), {}),
    ("lit_last_below", (EDGE - 3, 1, 1), {"lit": True}),
    ("lit_at_edge", (EDGE - 2, 1, 1), {"lit": True}),
    # 1289 x 1290^2 + 1290^2 + 1290 < 2^31 <= 1290^3 + 1290^2 + 1290
    ("cube_1289", (1289, 1290, 1290), {}),
    ("cube_1290", (1290, 1290, 1290), {}),
    # a slab of the 1290 cube holds its own planes; the light reads all
    ("slab_of_cube_1290", (1290, 1290, 1290), {"slab_x": 645}),
    ("lit_cube_1290", (1290, 1290, 1290), {"lit": True}),
    # three channel grids count three times: 3 x 716e6 + 1e6 + 1000 is past
    # 2^31, 3 x 715e6 + 1e6 + 1000 below it
    ("mc1_716", (716, 1000, 1000), {"chans": 1}),
    ("mc3_716", (716, 1000, 1000), {"chans": 3}),
    ("mc3_715", (715, 1000, 1000), {"chans": 3}),
    ("mc3_slab_of_1000", (1000, 1000, 1000), {"chans": 3, "slab_x": 500}),
])
def test_index_width_at_the_edge(case, dims, kw):
    d1, d2, d3 = dims
    elems = (kw.get("slab_x") or d1) * d2 * d3 * max(kw.get("chans", 0), 1)
    if kw.get("lit"):
        elems = max(elems, d1 * d2 * d3)
    want = elems + d2 * d3 + d3 <= EDGE - 1
    assert march.index32(_sized(dims, **kw)) == want
    # the cases sit on both sides of the edge as named
    assert want == (case.endswith("below") or case in (
        "cube_1289", "slab_of_cube_1290", "mc1_716", "mc3_715",
        "mc3_slab_of_1000"))


def test_index_width_of_the_main_paths():
    """MNI-dims, 512^3 and a 3-channel MNI-dims volume take 32 bits."""
    for dims, kw in (((182, 218, 182), {}), ((512, 512, 512), {}),
                     ((512, 512, 512), {"lit": True}),
                     ((182, 218, 182), {"chans": 3}),
                     ((182, 218, 182), {"slab_x": 91})):
        assert march.index32(_sized(dims, **kw))
