"""Port parity, the a0 voxel point cloud (``models/point_splat.py``), its
colourers (``models/debug_colors.py``, ``scene/voxel_colors.py``) and the
native rasterizer (``native/``): each against the JAX package on the CPU,
on a 24^3 sphere and a seeded 20x24x28 volume, at 24x24 and 32x20 pixels,
from tests/test_native.py's camera (0.3, 0.4, 0.9) and one on the far side
(-0.8, 0.5, -0.6).

Tolerances: ``voxel_positions``, ``render_points`` (the TF's colours and
every colourer's ``rgba=``), ``render_points_depth`` and the colourers bit
for bit; ``render_depth_vrc`` within 1e-6; the exact path within 1e-6 of
the JAX package's (its library is built with ``-march=native``, which may
fuse the blend's multiply-adds) and, as tests/test_native.py:124-142 holds
the JAX one, within 0.2 of the approximation on more than 70 % of the
pixels."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.models import debug_colors as jdebug
from volumerenderingproject_tpu.models import point_splat as jps
from volumerenderingproject_tpu.scene import voxel_colors as jvc

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop, native
from volumerenderingproject_tpu_torch.models import debug_colors
from volumerenderingproject_tpu_torch.models import point_splat as pps
from volumerenderingproject_tpu_torch.ops import march
from volumerenderingproject_tpu_torch.scene import voxel_colors
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

TF_FIELDS = ("lower", "upper", "colors", "hg_g")
CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL_DEPTH = 1e-6
SIZES = ((24, 24), (32, 20))
CAMS = ((0.3, 0.4, 0.9), (-0.8, 0.5, -0.6))


def _volumes():
    rng = np.random.default_rng(5)
    return {"sphere24": jsynthetic.centered_sphere(24),
            "seeded": J.make_volume(rng.uniform(0.0, 255.0, (20, 24, 28))
                                    .astype(np.float32))}


VOLUMES = _volumes()


def _port(jv, jtf, jc, jcfg):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc, RenderConfig.from_json(jcfg.to_json())


def _scene(vname, size, cam):
    jv = VOLUMES[vname]
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=cam)
    jcfg = J.RenderConfig(width=size[0], height=size[1], samples_per_ray=48)
    return (jv, jtf, jc, jcfg), _port(jv, jtf, jc, jcfg)


CASES = [(v, s, c) for v in sorted(VOLUMES) for s in SIZES for c in CAMS]


@pytest.mark.parametrize("vname", sorted(VOLUMES))
def test_voxel_positions_bit_equal(vname):
    jv = VOLUMES[vname]
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    np.testing.assert_array_equal(pps.voxel_positions(pv).numpy(),
                                  np.asarray(jps.voxel_positions(jv)))


@pytest.mark.parametrize("vname,size,cam", CASES)
def test_points_and_depths_match_jax(vname, size, cam):
    """The approximation with the TF's colours, through ``render()`` in
    every mode, and the two depth maps."""
    (jv, jtf, jc, jcfg), (pv, ptf, pc, pcfg) = _scene(vname, size, cam)
    want = np.asarray(jps.render_points(jv, jtf, jc, jcfg))
    got = pps.render_points(pv, ptf, pc, pcfg.replace(
        algorithm=P.Algorithm.POINT))
    np.testing.assert_array_equal(got.numpy(), want)
    for mode in ("auto", "fast", "scan"):
        img = P.render(pv, ptf, pc, pcfg.replace(algorithm=P.Algorithm.POINT),
                       mode=mode, device="cpu")
        np.testing.assert_array_equal(img.numpy(), want)
    np.testing.assert_array_equal(
        pps.render_points_depth(pv, pc, pcfg).numpy(),
        np.asarray(jps.render_points_depth(jv, jc, jcfg)))
    got = pps.render_depth_vrc(pv, ptf, pc, pcfg).numpy()
    want = np.asarray(jps.render_depth_vrc(jv, jtf, jc, jcfg))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_DEPTH)
    assert got[..., :3].min() >= 0.0 and got[..., :3].max() <= 1.0


COLOURERS = {
    "nifti_color_test": (lambda v: debug_colors.nifti_color_test(v),
                         lambda v: jdebug.nifti_color_test(v)),
    "nifti_color_test2": (lambda v: debug_colors.nifti_color_test2(v),
                          lambda v: jdebug.nifti_color_test2(v)),
    "sphere_octants": (lambda v: debug_colors.sphere_octants(v),
                       lambda v: jdebug.sphere_octants(v)),
    "intensity_bands": (lambda v: voxel_colors.intensity_bands(v),
                        lambda v: jvc.intensity_bands(v)),
    "intensity_green": (lambda v: voxel_colors.intensity_green(v),
                        lambda v: jvc.intensity_green(v)),
}


@pytest.mark.parametrize("name", sorted(COLOURERS))
@pytest.mark.parametrize("vname", sorted(VOLUMES))
def test_colourers_match_jax_and_render(name, vname):
    """Each colourer bit for bit, and the point cloud it colours, at
    32x20 from the far camera."""
    (jv, jtf, jc, jcfg), (pv, ptf, pc, pcfg) = _scene(vname, SIZES[1],
                                                       CAMS[1])
    ours, theirs = COLOURERS[name]
    got, want = ours(pv), np.asarray(theirs(jv))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        pps.render_points(pv, ptf, pc, pcfg,
                          rgba=got.reshape(-1, 4)).numpy(),
        np.asarray(jps.render_points(jv, jtf, jc, jcfg,
                                     rgba=want.reshape(-1, 4))))


@pytest.mark.parametrize("vname", sorted(VOLUMES))
def test_tf_colors_match_jax(vname):
    jv = VOLUMES[vname]
    jtf = J.default_transfer_function()
    pv, ptf, _, _ = _port(jv, jtf, J.Camera.initial(position=CAMS[0]),
                          J.RenderConfig())
    np.testing.assert_array_equal(voxel_colors.tf_colors(pv, ptf).numpy(),
                                  np.asarray(jvc.tf_colors(jv, jtf)))


def test_native_point_rasterize_draw_order():
    """tests/test_native.py:104-121 on the port's library: the first point
    blends over the background, a later nearer one on top, a later farther
    one is rejected."""
    bg = np.asarray([0.2, 0.2, 0.2, 1.0], np.float32)
    ndc = np.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, -0.5], [0.0, 0.0, 0.8]],
                     np.float32)
    rgba = np.asarray([[1, 0, 0, 0.5], [0, 1, 0, 0.5], [0, 0, 1, 0.5]],
                      np.float32)
    img = native.point_rasterize(ndc, rgba, 4, 4, bg)
    after_a = 0.5 * rgba[0, :3] + 0.5 * bg[:3]
    want = 0.5 * rgba[1, :3] + 0.5 * after_a
    np.testing.assert_allclose(img[2, 1, :3], want, rtol=1e-6)
    assert str(native.build.library_path()).startswith(
        str(native.build.BUILD_DIR))
    assert native.build.library_path().exists()


@pytest.mark.parametrize("vname", sorted(VOLUMES))
def test_exact_points_match_jax_and_the_approximation(vname):
    (jv, jtf, jc, jcfg), (pv, ptf, pc, pcfg) = _scene(vname, SIZES[0],
                                                       CAMS[0])
    exact = pps.render_points(pv, ptf, pc, pcfg, exact=True).numpy()
    np.testing.assert_allclose(
        exact, np.asarray(jps.render_points(jv, jtf, jc, jcfg, exact=True)),
        rtol=0, atol=1e-6)
    approx = pps.render_points(pv, ptf, pc, pcfg).numpy()
    assert np.isfinite(exact).all()
    close = np.isclose(exact[..., :3], approx[..., :3], atol=0.2).all(-1)
    assert close.mean() > 0.7


def test_point_render_needs_no_kernel_check():
    """``Algorithm.POINT`` renders: no check of the fused march refuses it,
    and ``render_vrc_sharded`` refuses it with the JAX CLI's message."""
    assert P.models.raycast.fast_refusal(
        None, None, RenderConfig(algorithm=P.Algorithm.POINT)) is None
    assert not hasattr(march, "check_supported")
    from volumerenderingproject_tpu_torch.parallel import render_dist

    with pytest.raises(NotImplementedError, match="single-device path"):
        render_dist.render_vrc_sharded(
            None, None, None, RenderConfig(algorithm=P.Algorithm.POINT), None)


def test_points_on_4d_volumes_classify_channel_0():
    rng = np.random.default_rng(9)
    data = rng.uniform(0.0, 255.0, (6, 7, 5, 3)).astype(np.float32)
    pv4 = interop.volume_from_numpy(data, 255.0, device="cpu")
    pv1 = interop.volume_from_numpy(np.ascontiguousarray(data[..., 0]), 255.0,
                                    device="cpu")
    tf = P.default_transfer_function(device="cpu")
    cam = P.reset_preset(device="cpu")
    cfg = RenderConfig(width=12, height=10, algorithm=P.Algorithm.POINT)
    for fn in (lambda v: pps.render_points(v, tf, cam, cfg),
               lambda v: pps.render_depth_vrc(v, tf, cam, cfg)):
        np.testing.assert_array_equal(fn(pv4).numpy(), fn(pv1).numpy())
    assert torch.isfinite(pps.render_points_depth(pv4, cam, cfg)).all()
