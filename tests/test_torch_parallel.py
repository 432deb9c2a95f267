"""Port parity, sharded renders (parallel/render_dist.py) in one process: the
work units' plain versions against the JAX package's segment kernels in
interpret mode, the composite fold, the offset ray setup, the scan segments
and what raises.  The CUDA kernels' segment and slab modes are held against
these plain versions on the card by chip_smoke.py; every unit of a mesh,
folded, against the JAX package's sharded render is in
tests/test_torch_parallel_fold.py, real multi-process runs in
tests/test_torch_parallel_spawn.py.

The scene is the JAX package's own (tests/test_parallel.py:15-25): an
8x10x9 volume, 16x6 pixels, 24 samples per ray, seed 7; early termination
0, so segments compose exactly."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import composite as jcomp
from volumerenderingproject_tpu.ops import pallas_a5 as jpa5
from volumerenderingproject_tpu.ops import pallas_march as jpm
from volumerenderingproject_tpu.parallel import render_dist as jrd
from volumerenderingproject_tpu.parallel.mesh import make_mesh as jmake_mesh

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.models import raycast
from volumerenderingproject_tpu_torch.ops import a5, march
from volumerenderingproject_tpu_torch.ops import composite as comp
from volumerenderingproject_tpu_torch.ops.phong import default_light
from volumerenderingproject_tpu_torch.parallel import launch
from volumerenderingproject_tpu_torch.parallel import mesh as pmesh
from volumerenderingproject_tpu_torch.parallel import render_dist
from volumerenderingproject_tpu_torch.scene.transfer_function import (
    TransferFunction)
from volumerenderingproject_tpu_torch.utils.config import (Algorithm, Interp,
                                                           RenderConfig)

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL_UNIT = 1e-5  # plain work unit vs interpret-mode Pallas
TOL_RAYS = 1e-6  # the rays axis alone: no fold, the same samples
TOL_FOLD = 1e-5  # folds regroup the float sums of (C, T)
SCENE_CFG = J.RenderConfig(width=16, height=6, samples_per_ray=24)
CAM = (0.4, 0.3, 0.9)
CAM_NEG_X = (0.6, 0.2, 0.7)  # front.x < 0: the slab fold runs backwards
CAM_CONIC = (0.05, 0.3, 1.2)  # the conic fan straddles dir.x = 0


def _volume(channels=1):
    rng = np.random.default_rng(7)
    shape = (8, 10, 9) if channels == 1 else (8, 10, 9, channels)
    return J.make_volume(rng.uniform(0.0, 255.0, size=shape)
                         .astype(np.float32))


def _port(jv, jtf, jc, jcfg):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc, RenderConfig.from_json(jcfg.to_json())


def _tf_alpha0(alpha=0.05):
    jtf = J.default_transfer_function()
    colors = np.asarray(jtf.colors).copy()
    colors[0, 3] = alpha
    return J.TransferFunction(jtf.lower, jtf.upper, colors, jtf.hg_g)


# ---- composite ---------------------------------------------------------------


def test_fold_segments_matches_jax():
    """Within 1e-6: XLA on the CPU fuses the fold's multiply-adds."""
    rng = np.random.default_rng(3)
    segs_c = rng.uniform(0, 1, (4, 5, 3, 3)).astype(np.float32)
    segs_t = rng.uniform(-0.2, 1, (4, 5, 3, 1)).astype(np.float32)
    pc = [torch.from_numpy(c) for c in segs_c]
    pt = [torch.from_numpy(t) for t in segs_t]
    for rev in (False, True):
        want = jrd._fold_segments_front_to_back(segs_c, segs_t,
                                                np.asarray(rev))
        got = comp.fold_segments(pc, pt, rev)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    mask = rng.uniform(size=(5, 3, 1)) < 0.5
    got = comp.fold_segments(pc, pt, torch.from_numpy(mask))
    asc = jrd._fold_segments_front_to_back(segs_c, segs_t, np.asarray(False))
    desc = jrd._fold_segments_front_to_back(segs_c, segs_t, np.asarray(True))
    for g, a, d in zip(got, asc, desc):
        np.testing.assert_allclose(g.numpy(), np.where(mask, np.asarray(d),
                                                       np.asarray(a)),
                                   rtol=0, atol=1e-6)
    f, b = (pc[0], pt[0]), (pc[1], pt[1])
    for g, w in zip(comp.segment_compose(f, b),
                    jcomp.segment_compose((segs_c[0], segs_t[0]),
                                          (segs_c[1], segs_t[1]))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


# ---- ray setup and the plain scan segments -----------------------------------


@pytest.mark.parametrize("conic", [False, True])
def test_offset_rays_match_jax(conic):
    jcfg = SCENE_CFG.replace(conic=conic)
    jc = J.Camera.initial(position=CAM_CONIC)
    _, _, pc, pcfg = _port(_volume(), J.default_transfer_function(), jc, jcfg)
    np.testing.assert_array_equal(
        raycast.ray_origins(pc, pcfg, 5, 7).numpy(),
        np.asarray(jraycast.ray_origins(jc, jcfg, 5, 7)))
    # lax.rsqrt on the CPU is not correctly rounded: conic directions
    # within an ulp or two
    np.testing.assert_allclose(
        raycast.primary_ray_dirs(pc, pcfg, 5, 7).numpy(),
        np.asarray(jraycast.primary_ray_dirs(jc, jcfg, 5, 7)), rtol=0,
        atol=1e-6)
    x, y = raycast.pixel_grid(pcfg, "cpu", 5, 7)
    jx, jy = jraycast.pixel_grid(jcfg, 5, 7)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


@pytest.mark.parametrize("case", ["a1_lit", "a1_smooth", "a5_lit"])
def test_scan_segments_match_jax(case):
    jv = _volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAM)
    jcfg = SCENE_CFG.replace(
        lighting=case != "a1_smooth",
        interp=J.Interp.TRILINEAR if case == "a1_smooth" else J.Interp.NEAREST,
        algorithm=J.Algorithm.TEST if case == "a5_lit" else J.Algorithm.VRC)
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    unit = dict(x_offset=4, local_width=8, s_start=5, s_count=11)
    jfn, fn = ((jraycast.render_test_segment, raycast.render_test_segment)
               if case == "a5_lit" else
               (jraycast.render_vrc_segment, raycast.render_vrc_segment))
    want = jfn(jv, jtf, jc, jcfg, **unit)
    got = fn(pv, ptf, pc, pcfg, **unit)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)


def test_whole_renders_keep_their_bits():
    """A unit that covers the whole image is the whole render."""
    jv = _volume()
    pv, ptf, pc, pcfg = _port(jv, J.default_transfer_function(),
                              J.Camera.initial(position=CAM), SCENE_CFG)
    whole = march.march_plain(march.prepare(pv, ptf, pc, pcfg, 0.0))
    c, t = march.render_vrc_fused(pv, ptf, pc, pcfg, segment=True)
    bg = torch.tensor(pcfg.background[:3])
    np.testing.assert_array_equal((c + t * bg).numpy(), whole[..., :3].numpy())
    seg = raycast.render_vrc(pv, ptf, pc, pcfg, mode="segment")
    unit = raycast.render_vrc_segment(pv, ptf, pc, pcfg)
    for g, w in zip(unit, seg):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


# ---- one work unit: plain version vs the JAX segment kernels -----------------


UNITS = {
    # rays x samples, s_start not a multiple of the kernels' 8-sample chunk
    "segment": dict(unit=dict(x_offset=4, local_width=4, s_start=5,
                              s_count=11)),
    "segment_conic": dict(unit=dict(x_offset=9, local_width=7, s_start=13,
                                    s_count=11), cfg=dict(conic=True)),
    # a slab under TF(0).alpha != 0: off-volume samples belong to the slab
    # of their x-clamped voxel
    "slab_alpha0": dict(unit=dict(x_offset=0, local_width=16, s_start=0,
                                  s_count=24, x0=2, slab_x=4), alpha0=0.05),
    "slab_first": dict(unit=dict(x_offset=8, local_width=8, s_start=8,
                                 s_count=16, x0=0, slab_x=2)),
    "slab_lut": dict(unit=dict(x_offset=0, local_width=16, s_start=0,
                               s_count=24, x0=4, slab_x=4),
                     cfg=dict(tf_lut=64)),
    "slab_mc": dict(unit=dict(x_offset=0, local_width=16, s_start=3,
                              s_count=21, x0=6, slab_x=2), channels=3),
}


@pytest.mark.parametrize("name", sorted(UNITS))
def test_march_unit_matches_pallas_interpret(name):
    case = UNITS[name]
    channels = case.get("channels", 1)
    jv = _volume(channels)
    jtf = _tf_alpha0(case["alpha0"]) if "alpha0" in case else (
        J.default_transfer_function())
    jc = J.Camera.initial(position=CAM)
    jcfg = SCENE_CFG.replace(**case.get("cfg", {}))
    u = dict(case["unit"])
    data = np.asarray(jv.data)
    if "slab_x" in u:
        data = data[u["x0"]:u["x0"] + u["slab_x"]]
    wc, wt = jpm.render_vrc_pallas_segment(
        data, jv.dims, jv.octree_depth, jv.cal_max, jtf, jc, jcfg,
        early_eps=0.0, interpret=True, channels=channels, **u)
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    a = march.prepare(pv, ptf, pc, pcfg, 0.0, segment=True, **u)
    assert a.ids.shape[0] == u.get("slab_x", jv.dims[0])
    c, t = march.march_plain(a)
    assert c.shape == (u["local_width"], 6, 3) and t.shape[-1] == 1
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=0,
                               atol=TOL_UNIT)
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=0,
                               atol=TOL_UNIT)


@pytest.mark.parametrize("lighting", [False, True])
def test_a5_unit_matches_pallas_interpret(lighting):
    jv = _volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAM)
    jcfg = SCENE_CFG.replace(algorithm=J.Algorithm.TEST, lighting=lighting)
    u = dict(x_offset=6, local_width=5, s_start=7, s_count=13)
    wc, wt = jpa5.render_test_pallas(jv, jtf, jc, jcfg, early_eps=0.0,
                                     interpret=True, segment=True, **u)
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    c, t = a5.march_a5_plain(a5.prepare_a5(pv, ptf, pc, pcfg, 0.0,
                                           segment=True, **u))
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=0,
                               atol=TOL_UNIT)
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=0,
                               atol=TOL_UNIT)


def test_slab_box_matches_jax():
    """The slab's box clip is the JAX package's float32 expression."""
    dims, depth, x0, slab = (182, 218, 182), 8, 91, 91
    lo, hi = march._box(dims, depth, x0, slab)
    L, n = np.float32(218.0), 256.0
    hg0 = np.float32(L / 2) - np.float32(182 / 2)
    x0f = np.float32(x0)
    full_lo, full_hi = march._box(dims, depth)
    assert lo[0] == max(np.float32(full_lo[0]), (hg0 + x0f) / L - 0.5)
    assert hi[0] == min(np.float32(full_hi[0]),
                        (hg0 + x0f + np.float32(slab)) / L
                        + np.float32(1.0 / n) - np.float32(0.5))
    assert lo[1:] == full_lo[1:] and hi[1:] == full_hi[1:]


# ---- what raises ------------------------------------------------------------


def _small():
    return _port(_volume(), J.default_transfer_function(),
                 J.Camera.initial(position=CAM), SCENE_CFG)


@pytest.mark.parametrize("case", [
    ("smooth_fast", (2, 2, 1), dict(interp=Interp.TRILINEAR), "fast", False,
     "mode='scan'"),
    ("light_fast", (2, 2, 1), {}, "fast", True, "mode='scan'"),
    ("lit_slab", (1, 1, 4), dict(lighting=True), "fast", False,
     "mode='scan'"),
    ("scattered_slab", (1, 1, 4), dict(scattering=True), "fast", False,
     "mode='scan'"),
    ("smooth_slab", (1, 1, 4), dict(interp=Interp.TRILINEAR), "fast", False,
     "mode='scan'"),
    ("a5_slab", (1, 2, 2), dict(algorithm=Algorithm.TEST), "fast", False,
     "mode='scan'"),
    ("scan_slab", (2, 1, 2), {}, "scan", False, None),
], ids=lambda c: c[0])
def test_uncovered_configs_raise(case):
    """A unit that no segment or slab kernel computes raises in fast mode,
    naming ``mode='scan'``, which computes it: the plain scan segments on
    the rays and samples axes, the slab scan on the volume axis (held to
    the single-device scan in tests/test_torch_slab_scan.py).  A plain
    slab takes the kernel or the slab scan, which agree."""
    _, shape, over, mode, light, match = case
    pv, ptf, pc, pcfg = _small()
    cfg = pcfg.replace(**over)
    lg = default_light("cpu") if light else None
    coords = (0, 0, shape[2] - 1)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            render_dist.render_segment(pv, ptf, pc, cfg, shape, coords,
                                       mode=mode, light=lg)
    c, t = render_dist.render_segment(pv, ptf, pc, cfg, shape, coords,
                                      mode="scan", light=lg)
    assert c.shape == (cfg.width // shape[0], cfg.height, 3)
    assert t.shape == (cfg.width // shape[0], cfg.height, 1)
    if match is None:
        fc, ft = render_dist.render_segment(pv, ptf, pc, cfg, shape, coords,
                                            light=lg)
        np.testing.assert_allclose(c.numpy(), fc.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t.numpy(), ft.numpy(), rtol=0, atol=1e-6)


def test_bad_meshes_and_units_raise():
    pv, ptf, pc, pcfg = _small()
    for shape in ((3, 1, 1), (1, 5, 1), (1, 1, 3)):
        with pytest.raises(ValueError):
            render_dist.render_segment(pv, ptf, pc, pcfg, shape, (0, 0, 0))
    with pytest.raises(ValueError, match="unknown mode"):
        render_dist.render_segment(pv, ptf, pc, pcfg, (2, 1, 1), (1, 0, 0),
                                   mode="reference")
    with pytest.raises(ValueError, match="outside"):
        march.prepare(pv, ptf, pc, pcfg, 0.0, x_offset=12, local_width=8)
    with pytest.raises(ValueError, match="slab"):
        march.prepare(pv, ptf, pc, pcfg, 0.0, x0=6, slab_x=4)
    with pytest.raises(RuntimeError, match="initialised"):
        pmesh.make_mesh(2)


def test_ranks_need_cuda_without_a_device(monkeypatch):
    """No quiet move to the CPU: a rank goes there only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.rank_device(0, "gloo")
    assert launch.rank_device(3, "gloo", "cpu") == torch.device("cpu")


@pytest.mark.parametrize("case", [
    ("lut", (2, 2, 1), dict(tf_lut=64), 1, False, "mode='scan'"),
    ("multichannel", (2, 2, 1), {}, 3, False, "mode='scan'"),
    ("smooth", (1, 2, 1), dict(interp=Interp.TRILINEAR), 1, False,
     "mode='scan'"),
    ("conic_lit", (2, 2, 1), dict(conic=True, lighting=True), 1, False,
     "mode='scan'"),
    ("light_on_volume_axis", (1, 1, 4), dict(lighting=True), 1, True,
     "mode='scan'"),
], ids=lambda c: c[0])
def test_sharded_fits_outside_the_kernels_raise(case):
    """A sharded fit's work unit that no differentiable kernel takes raises
    in fast mode, naming the scan route, which fits it (the scan segments,
    or the slab scan on the volume axis: tests/test_torch_scan_fit_sharded.py
    and tests/test_torch_slab_scan.py hold their gradients to the JAX
    package's); fast mode never drops to the scan segments or the plain
    versions."""
    _, shape, over, channels, light, match = case
    jv = _volume(channels)
    pv, ptf, pc, pcfg = _port(jv, J.default_transfer_function(),
                              J.Camera.initial(position=CAM), SCENE_CFG)
    cfg = pcfg.replace(**over)
    lg = default_light("cpu") if light else None
    coords = (0, 0, shape[2] - 1)
    with pytest.raises(NotImplementedError, match=match):
        render_dist.render_segment(pv, ptf, pc, cfg, shape, coords, light=lg,
                                   differentiable=True)
    colors = ptf.colors.clone().requires_grad_()
    tf2 = TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g)
    c, t = render_dist.render_segment(pv, tf2, pc, cfg, shape, coords,
                                      light=lg, differentiable=True,
                                      mode="scan")
    (c.sum() + t.sum()).backward()
    assert torch.isfinite(colors.grad).all()


def test_kernel_wrappers_refuse_cpu_units():
    """No fallback: on CPU tensors the wrappers raise, the fused entry
    points run the plain versions."""
    pv, ptf, pc, pcfg = _small()
    a = march.prepare(pv, ptf, pc, pcfg, 0.0, x0=2, slab_x=2, segment=True)
    with pytest.raises(ValueError, match="CUDA"):
        march.march_kernel(a)
    a5a = a5.prepare_a5(pv, ptf, pc, pcfg, 0.0, s_start=4, s_count=4,
                        segment=True)
    with pytest.raises(ValueError, match="CUDA"):
        a5.march_a5_kernel(a5a)
