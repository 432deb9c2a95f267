"""Port parity, sharded renders (parallel/render_dist.py) in one process:
every work unit of a mesh, run by the port's plain versions and folded as
``render_vrc_sharded`` folds them, without the gathers, against the JAX
package's ``render_vrc_sharded`` with its XLA scan segments
(``use_pallas=False``; tests/test_parallel.py's own reference path).

The scene is the JAX package's own (tests/test_parallel.py:15-25): an
8x10x9 volume, 16x6 pixels, 24 samples per ray, seed 7; early termination
0.  The rays axis alone regroups nothing (1e-6); folds regroup the (C, T)
sums (1e-5)."""

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.parallel import render_dist as jrd
from volumerenderingproject_tpu.parallel.mesh import make_mesh as jmake_mesh

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import composite as comp
from volumerenderingproject_tpu_torch.parallel import render_dist
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL_RAYS = 1e-6
TOL_FOLD = 1e-5
SCENE_CFG = J.RenderConfig(width=16, height=6, samples_per_ray=24)
CAM = (0.4, 0.3, 0.9)
CAM_NEG_X = (0.6, 0.2, 0.7)  # front.x < 0: the slab fold runs backwards
CAM_CONIC = (0.05, 0.3, 1.2)  # the conic fan straddles dir.x = 0


def _volume(channels=1):
    rng = np.random.default_rng(7)
    shape = (8, 10, 9) if channels == 1 else (8, 10, 9, channels)
    return J.make_volume(rng.uniform(0.0, 255.0, size=shape)
                         .astype(np.float32))


def _sharded(volume, tf, camera, config, shape, mode="fast"):
    """Every work unit of a ``shape`` mesh in this process, folded as
    ``render_vrc_sharded`` folds what it gathers -> [W, H, 4]."""
    n_rays, n_samp, n_vol = shape
    w = config.width // n_rays
    cols = []
    for ri in range(n_rays):
        segs = []
        for si in range(n_samp):
            units = [render_dist.render_segment(volume, tf, camera, config,
                                                shape, (ri, si, vi),
                                                mode=mode)
                     for vi in range(n_vol)]
            segs.append(render_dist.fold_volume(
                [u[0] for u in units], [u[1] for u in units], camera, config,
                ri * w, w) if n_vol > 1 else units[0])
        seg = comp.fold_segments([s[0] for s in segs], [s[1] for s in segs])
        cols.append(comp.segment_finalize(
            seg, torch.tensor(config.background, dtype=torch.float32)))
    return torch.cat(cols, dim=0)


def _port(jv, jtf, jc, jcfg):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc, RenderConfig.from_json(jcfg.to_json())


# ---- every unit of a mesh, folded, vs the JAX package's sharded render ------


MESHES = {
    "rays8": dict(mesh=(8, 1, 1), tol=TOL_RAYS),
    "samples": dict(mesh=(2, 4, 1)),
    "volume": dict(mesh=(2, 1, 4)),
    "full_3d": dict(mesh=(2, 2, 2)),
    "negative_front_x": dict(mesh=(1, 2, 4), cam=CAM_NEG_X),
    "conic_volume": dict(mesh=(1, 1, 8), cam=CAM_CONIC, cfg=dict(conic=True)),
    "a5": dict(mesh=(2, 2, 1), cfg=dict(algorithm=J.Algorithm.TEST)),
    # the JAX package's slab scan ignores tf_lut (render_dist.py:736-):
    # its single render, whose LUT its segment kernel follows, is the
    # reference here
    "lut_slabs": dict(mesh=(2, 1, 4), cfg=dict(tf_lut=64), single=True),
    "mc_slabs": dict(mesh=(1, 2, 4), channels=3),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_units_fold_to_jax_sharded(name):
    case = MESHES[name]
    jv = _volume(case.get("channels", 1))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=case.get("cam", CAM))
    jcfg = SCENE_CFG.replace(**case.get("cfg", {}))
    if case.get("single"):
        want = np.asarray(jraycast.render_vrc(jv, jtf, jc, jcfg))
    else:
        want = np.asarray(jrd.render_vrc_sharded(
            jv, jtf, jc, jcfg, jmake_mesh(*case["mesh"]), use_pallas=False))
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    got = _sharded(pv, ptf, pc, pcfg, case["mesh"])
    assert got.shape == want.shape == (16, 6, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=case.get("tol", TOL_FOLD))


def test_scan_units_fold_to_jax_sharded():
    """mode='scan': smooth mode on the rays and samples axes through the
    plain scan segments."""
    jv = _volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAM)
    jcfg = SCENE_CFG.replace(interp=J.Interp.TRILINEAR)
    want = np.asarray(jrd.render_vrc_sharded(
        jv, jtf, jc, jcfg, jmake_mesh(2, 2, 1), use_pallas=False))
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    got = _sharded(pv, ptf, pc, pcfg, (2, 2, 1), mode="scan")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_FOLD)
