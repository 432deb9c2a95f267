"""Port parity, the volume-axis slab scan (``parallel/render_dist.
render_segment_volume_slab``, ``mode="scan"`` on the volume axis): the
x-slab samplers (ops/sampling.py) bit for bit against the JAX package's on
halo-extended slabs; every unit of a mesh folded as ``render_vrc_sharded``
folds them, against the JAX package's single-device XLA scan, on lit
(central, Sobel, presmoothed), scattered (the light along x and along y),
smooth, ``Interp.TRILINEAR_COLOR``, a5, conic, LUT and 4-D renders; and
slab-scan fits with a light and with a5, every rank in a thread of its own
(tests/test_torch_parallel_fit.py's ``_ThreadMesh``), against ``jax.grad``
through the JAX scan.

The scene is the JAX package's own (tests/test_parallel.py:15-25): an
8x10x9 volume, 16x6 pixels, 24 samples per ray, seed 7.  Folded renders
within 2e-5 of the single-device scan (the JAX slab scan ignores
``tf_lut`` and leaves a5 slabs unscattered, so the single render is the
reference everywhere); gradients as tests/test_torch_scan_fit_sharded.py
takes them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models import raycast as jraycast
from volumerenderingproject_tpu.ops import phong as jphong
from volumerenderingproject_tpu.ops import sampling as jsampling

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import composite as comp
from volumerenderingproject_tpu_torch.ops import march, sampling
from volumerenderingproject_tpu_torch.parallel import render_dist

import test_torch_parallel_fit as PF
import test_torch_scan_fit_sharded as SF

TOL = 2e-5
CAM_NEG_X = (0.6, 0.2, 0.7)  # front.x < 0: the slab fold runs backwards


def _light(direction):
    return dataclasses.replace(jphong.default_light(),
                               direction=jnp.asarray(direction, jnp.float32))


def _fold(pv, ptf, pc, pcfg, shape, light=None):
    """Every unit of a ``shape`` mesh through the slab scan, folded as
    ``render_vrc_sharded`` folds what it gathers -> [W, H, 4]."""
    n_rays, n_samp, n_vol = shape
    w = pcfg.width // n_rays
    cols = []
    for ri in range(n_rays):
        segs = []
        for si in range(n_samp):
            units = [render_dist.render_segment(
                pv, ptf, pc, pcfg, shape, (ri, si, vi), mode="scan",
                light=light) for vi in range(n_vol)]
            segs.append(render_dist.fold_volume(
                [u[0] for u in units], [u[1] for u in units], pc, pcfg,
                ri * w, w))
        seg = comp.fold_segments([s[0] for s in segs], [s[1] for s in segs])
        cols.append(comp.segment_finalize(
            seg, torch.tensor(pcfg.background, dtype=torch.float32)))
    return torch.cat(cols, dim=0)


RENDERS = {
    "lit_central": dict(mesh=(1, 1, 4), cfg=dict(lighting=True)),
    "lit_sobel": dict(mesh=(2, 1, 4), cfg=dict(lighting=True,
                                               gradient_filter="sobel"),
                      cam=CAM_NEG_X),
    "lit_presmoothed": dict(mesh=(1, 2, 4), cfg=dict(lighting=True,
                                                     presmooth_sigma=1.0)),
    "scattered_light_x": dict(mesh=(1, 1, 4), cfg=dict(scattering=True),
                              light=(1.0, 0.2, 0.1)),
    "scattered_light_y": dict(mesh=(1, 1, 8), cfg=dict(scattering=True),
                              light=(0.2, -1.0, 0.3)),
    "smooth": dict(mesh=(1, 1, 4), cfg=dict(interp=J.Interp.TRILINEAR)),
    "smooth_lit": dict(mesh=(1, 1, 8), cfg=dict(interp=J.Interp.TRILINEAR,
                                                lighting=True)),
    "trilinear_color": dict(mesh=(1, 1, 4),
                            cfg=dict(interp=J.Interp.TRILINEAR_COLOR)),
    "a5": dict(mesh=(1, 1, 4), cfg=dict(algorithm=J.Algorithm.TEST)),
    "a5_lit_slabs_of_one_plane": dict(mesh=(1, 1, 8), cfg=dict(
        algorithm=J.Algorithm.TEST, lighting=True)),
    "a5_scattered": dict(mesh=(1, 1, 4), cfg=dict(algorithm=J.Algorithm.TEST,
                                                  scattering=True)),
    "conic_lit": dict(mesh=(1, 1, 8), cfg=dict(conic=True, lighting=True),
                      cam=PF.CAM_CONIC),
    "lut_density": dict(mesh=(2, 1, 4), cfg=dict(tf_lut=64,
                                                 density_scale=0.6)),
    "explicit_light": dict(mesh=(1, 1, 4), cfg={}, light=(0.3, -0.5, 0.8)),
    "4d_lit": dict(mesh=(1, 2, 4), cfg=dict(lighting=True), channels=3),
    "plain": dict(mesh=(1, 1, 4), cfg={}),
}


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_slab_scan_folds_to_jax_single(name):
    """Every unit through the slab scan, folded, against the JAX package's
    single-device scan; ``mode="fast"`` raises where no slab kernel takes
    the config, naming ``mode='scan'``."""
    case = RENDERS[name]
    jv = SF._volume(case.get("channels", 1))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=case.get("cam", PF.CAM))
    jcfg = PF.SCENE_CFG.replace(**case["cfg"])
    jl = _light(case["light"]) if "light" in case else None
    scan = (jraycast.render_test if jcfg.algorithm is J.Algorithm.TEST
            else jraycast.render_vrc)
    want = np.asarray(scan(jv, jtf, jc, jcfg, mode="fast", light=jl))
    pv, ptf, pc, pcfg = PF._port(jv, jtf, jc, jcfg)
    pl = None if jl is None else interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in PF.LIGHT_FIELDS), device="cpu")
    got = _fold(pv, ptf, pc, pcfg, case["mesh"], pl)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    if name in ("plain", "lut_density"):
        return
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        render_dist.render_segment(pv, ptf, pc, pcfg, case["mesh"],
                                   (0, 0, 1), light=pl)


@pytest.mark.parametrize("x0,slab_x,hw", [(0, 2, 2), (2, 2, 2), (6, 2, 2),
                                          (0, 1, 3), (4, 4, 4), (7, 1, 2)])
def test_slab_samplers_match_jax(x0, slab_x, hw):
    """Each slab sampler against the JAX package's on the same extended
    slab, at seeded points inside, around and off the volume: values and
    ownership bit for bit; the halo a slice of the volume, zero past its
    faces."""
    rng = np.random.default_rng(x0 * 10 + slab_x)
    data = rng.uniform(-20.0, 255.0, (8, 10, 9)).astype(np.float32)
    dims, depth = (8, 10, 9), 4
    ext = render_dist._with_x_halo(torch.from_numpy(data), x0, slab_x, hw)
    pad = np.zeros((hw, 10, 9), np.float32)
    want_ext = np.concatenate([pad, data, pad])[x0:x0 + slab_x + 2 * hw]
    np.testing.assert_array_equal(ext.numpy(), want_ext)
    ext_flat = ext.reshape(-1)
    slab_flat = torch.from_numpy(data[x0:x0 + slab_x]).reshape(-1)
    jtf = J.default_transfer_function()
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in PF.TF_FIELDS), device="cpu")
    cal = np.float32(200.9)
    unit = rng.uniform(-0.1, 1.1, (64, 3)).astype(np.float32)
    vox = rng.uniform(-1.5, 10.5, (64, 3)).astype(np.float32)
    vox[:8] = np.floor(vox[:8])  # points on voxel planes

    def same(got, want):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    same(sampling.octree_nn_sample_slab(slab_flat, dims, depth,
                                        torch.from_numpy(unit), x0, slab_x),
         jsampling.octree_nn_sample_slab(jnp.asarray(slab_flat.numpy()), dims,
                                         depth, unit, x0, slab_x))
    same(sampling.octree_nn_index_slab(dims, depth, torch.from_numpy(unit),
                                       x0, slab_x),
         jsampling.octree_nn_index_slab(dims, depth, unit, x0, slab_x))
    same([sampling.corner_intensities_slab(ext_flat, dims,
                                           torch.from_numpy(vox), x0, slab_x,
                                           hw)],
         [jsampling.corner_intensities_slab(jnp.asarray(ext_flat.numpy()),
                                            dims, vox, x0, slab_x, hw)])
    same(sampling.trilinear_intensity_sample_slab(
        ext, dims, torch.from_numpy(vox), x0, slab_x, hw),
        jsampling.trilinear_intensity_sample_slab(
            jnp.asarray(ext.numpy()), dims, vox, x0, slab_x, hw))
    same(sampling.trilinear_color_sample_slab(
        ext_flat, dims, torch.from_numpy(vox), ptf.classify,
        torch.tensor(cal), x0, slab_x, hw),
        jsampling.trilinear_color_sample_slab(
            jnp.asarray(ext_flat.numpy()), dims, vox, jtf.classify,
            jnp.asarray(cal), x0, slab_x, hw))
    np.testing.assert_array_equal(
        sampling.slab_owner_x(torch.tensor([-3, 0, 5, 9]), 8).numpy(),
        np.asarray(jsampling.slab_owner_x(jnp.asarray([-3, 0, 5, 9]), 8)))


SLAB_FITS = {
    "light_central": dict(mesh=(1, 1, 4), cfg=dict(lighting=True)),
    "light_presmoothed_rays": dict(mesh=(2, 1, 2), cfg=dict(
        lighting=True, presmooth_sigma=1.0)),
    "light_conic": dict(mesh=(1, 2, 2), cfg=dict(conic=True),
                        cam=PF.CAM_CONIC),
    "a5": dict(mesh=(1, 1, 4), cfg=dict(algorithm=J.Algorithm.TEST)),
    "a5_samples": dict(mesh=(1, 2, 2), cfg=dict(algorithm=J.Algorithm.TEST)),
}


@pytest.mark.parametrize("name", sorted(SLAB_FITS))
def test_slab_scan_fits_match_jax_grad(name):
    """Slab-scan fits with a light or a5: dcolors (and the light's ten
    gradients) summed over the ranks against jax.grad through the JAX
    single-device scan; ``mode="fast"`` raises, naming ``mode='scan'``."""
    case = SLAB_FITS[name]
    light = None if case["cfg"].get("algorithm") else _light((0.4, 0.5, 0.77))
    pv, ptf, pc, pcfg, _ = SF.check_mesh(case, light=light)
    pl = None if light is None else interop.light_from_numpy(
        *(np.asarray(getattr(light, k)) for k in PF.LIGHT_FIELDS),
        device="cpu")
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        render_dist.render_segment(pv, ptf, pc, pcfg, case["mesh"],
                                   (0, 0, 1), differentiable=True, light=pl)


def test_slab_kernel_check_names_the_scan():
    cfg = PF._port(PF._volume(), J.default_transfer_function(),
                   J.Camera.initial(position=PF.CAM), PF.SCENE_CFG)[3]
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        march.check_slab_supported(cfg.replace(lighting=True), None)
    assert render_dist._slab_halo_width(cfg) == 2
    assert render_dist._slab_halo_width(cfg.replace(presmooth_sigma=1.0)) == 4
    for interp in (J.Interp.TRILINEAR, J.Interp.TRILINEAR_COLOR):
        assert render_dist._slab_halo_width(cfg.replace(
            presmooth_sigma=1.0, interp=interp)) == 5
