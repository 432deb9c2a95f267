"""Port parity, the volume-axis slab scan's x-halo under presmoothing
where the a1 samples are trilinear (``parallel/render_dist.
_slab_halo_width``, ROADMAP.md §3 F6): a slab owns a smooth or
``Interp.TRILINEAR_COLOR`` sample by its trilinear corners and shades it at
its octree-NN voxel, which may lie one plane past the slab, so the halo
takes the Gaussian radius + 2 planes (the JAX slab scan keeps radius + 1).
Lit presmoothed slabs on (1, 1, 4), conic, Sobel, sigma 1 and 0.7: the
folded slab scan within 2e-5 of the single-device ``render(mode="scan")``,
and the slab light fit's dcolors and ten light gradients, summed over the
threaded ranks, against jax.grad of the JAX single-device loss
(tests/test_torch_scan_fit_sharded.py's tolerances).  The scene and the
fold are tests/test_torch_slab_scan.py's."""

import numpy as np
import pytest

import volumerenderingproject_tpu as J

import volumerenderingproject_tpu_torch as P

import test_torch_parallel_fit as PF
import test_torch_scan_fit_sharded as SF
from test_torch_slab_scan import TOL, _fold, _light


# presmoothed lit slabs whose a1 samples are trilinear: a slab owns such a
# sample by its corners and shades it at its octree-NN voxel, one plane
# past the slab at most, so the halo takes the Gaussian radius + 2 planes
PRESMOOTHED_TRILINEAR = {
    f"{interp.name.lower()}_sigma{sigma}": dict(
        mesh=(1, 1, 4), cam=PF.CAM_CONIC, cfg=dict(
            interp=interp, lighting=True, conic=True,
            gradient_filter="sobel", presmooth_sigma=sigma))
    for interp in (J.Interp.TRILINEAR, J.Interp.TRILINEAR_COLOR)
    for sigma in (1.0, 0.7)}


@pytest.mark.parametrize("name", sorted(PRESMOOTHED_TRILINEAR))
def test_presmoothed_trilinear_slabs_match_single_scan(name):
    """Smooth and ``TRILINEAR_COLOR`` lit presmoothed slabs on (1, 1, 4),
    conic, Sobel: the folded slab scan within 2e-5 of the single-device
    ``render(mode="scan")``, and the slab light fit's dcolors and ten light
    gradients against jax.grad of the JAX single-device loss."""
    case = PRESMOOTHED_TRILINEAR[name]
    jv = SF._volume(1)
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=case["cam"])
    jcfg = PF.SCENE_CFG.replace(**case["cfg"])
    pv, ptf, pc, pcfg = PF._port(jv, jtf, jc, jcfg)
    want = P.render(pv, ptf, pc, pcfg, mode="scan", device="cpu")
    got = _fold(pv, ptf, pc, pcfg, case["mesh"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    SF.check_mesh(case, light=_light((0.4, 0.5, 0.77)))
