"""Port parity of the last utilities: the render-to-texture display
(``utils/texture.py``) and ``render --window``, the min/max pyramid
(``accel/pyramid.py``) with its descent trace, the reference's convolution
demo (``ops/conv3d.conv3d``, ``reference_kernel``) and the materialized
composites (``ops/composite.composite_back_to_front``,
``composite_front_to_back``), each against the JAX package's on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from volumerenderingproject_tpu.accel import pyramid as jpyramid
from volumerenderingproject_tpu.harness import cli as jcli
from volumerenderingproject_tpu.ingest.volume import make_volume as jmake
from volumerenderingproject_tpu.ops import composite as jcomposite
from volumerenderingproject_tpu.ops import conv3d as jconv3d
from volumerenderingproject_tpu.utils import texture as jtexture

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import native
from volumerenderingproject_tpu_torch.accel import pyramid
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch.ops import composite, conv3d
from volumerenderingproject_tpu_torch.utils import imageio, texture

TOL = 1e-6  # texture, composites: absolute; conv3d: relative to max |JAX|


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---- texture ---------------------------------------------------------------

@pytest.mark.parametrize("out", [(13, 9), (40, 27), (7, 5), (1, 1), (100, 3)])
def test_texture_quad_display(out):
    img = np.random.default_rng(0).random((13, 9, 4)).astype(np.float32)
    want = np.asarray(jtexture.texture_quad_display(img, *out))
    got = texture.texture_quad_display(_t(img), *out).numpy()
    assert got.shape == want.shape == out + (4,)
    assert np.abs(got - want).max() <= TOL


def test_sample_bilinear_clamps_like_jax():
    rng = np.random.default_rng(1)
    img = rng.random((11, 6, 3)).astype(np.float32)
    u, v = (rng.uniform(-0.3, 1.3, (17, 5)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jtexture.sample_bilinear(img, u, v))
    got = texture.sample_bilinear(_t(img), _t(u), _t(v)).numpy()
    assert np.abs(got - want).max() <= TOL


def test_stub_blue():
    assert np.array_equal(texture.stub_blue(5, 3, device="cpu").numpy(),
                          np.asarray(jtexture.stub_blue(5, 3)))


@pytest.mark.parametrize("window,alg", [("30x20", "vrc"), ("9x41", "test"),
                                        ("16x16", "vrc")])
def test_render_window(tmp_path, window, alg):
    """``render --window WxH`` writes a [H, W] PNG of the render drawn on
    the quad, within a level of the JAX CLI's."""
    args = ["render", "--data", "sphere", "--width", "16", "--height", "16",
            "--spr", "12", "--algorithm", alg, "--window", window]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "jax.png")
    assert cli.main(args + ["--out", ours, "--device", "cpu"]) == 0
    assert jcli.main(args + ["--out", theirs]) == 0
    ww, wh = (int(x) for x in window.split("x"))
    with open(ours, "rb") as f:
        got = imageio.decode_png(f.read()).astype(np.int32)
    want = np.asarray(Image.open(theirs), np.int32)
    assert got.shape == want.shape == (wh, ww, 3)
    assert np.abs(got - want).max() <= 1
    cfg = P.RenderConfig(width=16, height=16, samples_per_ray=12,
                         algorithm=P.Algorithm[alg.upper()])
    frame = P.render(synthetic.centered_sphere(device="cpu"),
                     P.default_transfer_function("cpu"),
                     P.reset_preset("cpu"), cfg, device="cpu")
    direct = imageio.to_uint8(imageio.to_display(
        texture.texture_quad_display(frame, ww, wh), cfg.algorithm))
    assert np.array_equal(got, direct[..., :3])


# ---- the min/max pyramid ---------------------------------------------------

def _volume(dims, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(20, 50, dims).astype(np.float32)
    d[d < 0] *= 0.3
    if len(dims) == 3:
        d[: dims[0] // 2] = 0.0  # a homogeneous half: early stops
    return d


@pytest.mark.parametrize("dims", [(13, 17, 11), (16, 16, 16), (5, 30, 9),
                                  (40, 3, 3), (7, 9, 5, 3)])
def test_pyramid_levels_bit_equal(dims):
    d = _volume(dims, 2)
    vol = P.make_volume(d, device="cpu")
    got = pyramid.build_pyramid(vol)
    want = jpyramid.build_pyramid(jmake(d))
    nmin, nmax = native.build_pyramid(d if d.ndim == 3 else d[..., 0],
                                      vol.octree_depth)
    assert got.depth == want.depth == len(nmin) - 1
    for g, w, n in zip(got.levels_min + got.levels_max,
                       want.levels_min + want.levels_max, nmin + nmax):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), n)
    assert np.array_equal(pyramid.leaf_grid(vol).numpy(),
                          np.asarray(jpyramid.leaf_grid(jmake(d))))
    for lvl in range(got.depth + 1):
        assert np.array_equal(got.occupancy(lvl).numpy(),
                              np.asarray(want.occupancy(lvl)))
        assert (float(pyramid.occupancy_fraction(got, lvl))
                == float(jpyramid.occupancy_fraction(want, lvl)))
    assert float(got.root_min()) == float(want.root_min())
    assert float(got.root_max()) == float(want.root_max())


@pytest.mark.parametrize("dims", [(13, 17, 11), (16, 16, 16), (40, 3, 3)])
def test_trace_query_lines_equal(dims):
    d = _volume(dims, 3)
    got_pyr = pyramid.build_pyramid(P.make_volume(d, device="cpu"))
    want_pyr = jpyramid.build_pyramid(jmake(d))
    points = np.random.default_rng(4).random((24, 3)).tolist()
    points += [[0.1, 0.5, 0.5], [0.0, 0.0, 0.0], [0.999, 0.5, 0.2],
               [1.2, 0.0, 0.0], [-0.1, 0.3, 0.3]]
    for p in points:
        got, want = [], []
        vg = pyramid.trace_query(got_pyr, p, out=got.append)
        vw = jpyramid.trace_query(want_pyr, p, out=want.append)
        assert got == want and vg == vw


# ---- the convolution demo --------------------------------------------------

@pytest.mark.parametrize("kshape", ["reference", (3, 3, 3), (5, 3, 1),
                                    (1, 1, 7)])
def test_conv3d(kshape):
    rng = np.random.default_rng(5)
    v = rng.normal(0, 50, (13, 17, 11)).astype(np.float32)
    k = (conv3d.reference_kernel("cpu").numpy() if kshape == "reference"
         else rng.normal(size=kshape).astype(np.float32))
    want = np.asarray(jconv3d.conv3d(jnp.asarray(v), jnp.asarray(k)))
    got = conv3d.conv3d(_t(v), _t(k)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale
    # the native library's summation, bit for bit
    assert np.array_equal(got, native.conv3d(v, k))


def test_conv3d_even_kernel_pads_like_same():
    """An even kernel is padded (k - 1) // 2 before and k // 2 after, as
    ``lax.conv_general_dilated``'s SAME does."""
    rng = np.random.default_rng(6)
    v = rng.normal(0, 50, (9, 8, 7)).astype(np.float32)
    k = rng.normal(size=(2, 4, 3)).astype(np.float32)
    want = np.asarray(jconv3d.conv3d(jnp.asarray(v), jnp.asarray(k)))
    got = conv3d.conv3d(_t(v), _t(k)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_reference_kernel_equal():
    assert np.array_equal(conv3d.reference_kernel("cpu").numpy(),
                          np.asarray(jconv3d.reference_kernel()))


# ---- the composites --------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 7, 40, 4), (33, 4), (3, 2, 2, 1, 4)])
@pytest.mark.parametrize("name", ["composite_back_to_front",
                                  "composite_front_to_back"])
def test_composites(shape, name):
    rng = np.random.default_rng(7)
    s = rng.random(shape).astype(np.float32)
    s[..., 3] *= rng.choice([0.0, 1.0], shape[:-1])  # empty samples too
    bg = (0.2, 0.3, 0.4, 1.0)
    want = np.asarray(getattr(jcomposite, name)(jnp.asarray(s), bg))
    got = getattr(composite, name)(_t(s), bg).numpy()
    assert got.shape == want.shape == shape[:-2] + (4,)
    assert np.abs(got - want).max() <= TOL
    assert (got[..., 3] == 1.0).all()
