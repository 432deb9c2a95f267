"""Port parity, sharded fits through the scan segments
(``parallel/render_dist.render_segment(differentiable=True, mode="scan")``,
``diff/fit.render_loss(mesh=..., mode="scan")``) on the rays and samples
axes: every rank of a mesh in a thread of its own, joined by an in-process
gather (tests/test_torch_parallel_fit.py's ``_ThreadMesh``), differentiated
through ``Mesh.all_gather``'s own-slice backward, their dcolors summed,
against ``jax.grad`` through the JAX package's single-device XLA scan, on
the configs that no differentiable work unit computes; and ``mode="fast"``
raising for them, naming ``mode='scan'``.

The scene is the JAX package's own (tests/test_parallel.py:15-25): an
8x10x9 volume, 16x6 pixels, 24 samples per ray, seed 7; gradients rtol
1e-4 and atol 1e-7 (rtol 5e-3 for a5 and smooth, as the single-device scan
route's tests take them), light gradients rtol 2e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.models.raycast import render_vrc as jrender_vrc
from volumerenderingproject_tpu.ops import phong as jphong

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.ops import phong
from volumerenderingproject_tpu_torch.parallel import render_dist

import test_torch_parallel_fit as PF

RTOL, ATOL = PF.RTOL, PF.ATOL
RTOL_LOOSE = 5e-3
RTOL_LIGHT, ATOL_LIGHT = PF.RTOL_LIGHT, PF.ATOL_LIGHT
K20 = 20


def _tf20():
    rng = np.random.default_rng(K20)
    lo = np.sort(rng.uniform(0.0, 1.0, K20)).astype(np.float32)
    lo[0] = 0.0
    up = np.minimum(lo + np.float32(0.12), np.float32(1.0)).astype(np.float32)
    up[0] = 1.0
    colors = rng.uniform(0.0, 1.0, (K20, 4)).astype(np.float32)
    colors[0, 3] = 0.0
    colors[1:, 3] *= np.float32(0.3)
    return J.TransferFunction(lower=jnp.asarray(lo), upper=jnp.asarray(up),
                              colors=jnp.asarray(colors),
                              hg_g=jnp.zeros(K20, jnp.float32))


def _volume(channels):
    if channels == 1:
        return PF._volume()
    rng = np.random.default_rng(7)
    return J.make_volume(rng.uniform(0.0, 255.0, size=(8, 10, 9, channels))
                         .astype(np.float32))


# the sharded fits that no differentiable work unit computes, and the plain
# one, which the scan route fits too
MESHES = {
    "lut": dict(mesh=(2, 2, 1), cfg=dict(tf_lut=64)),
    "multichannel": dict(mesh=(2, 2, 1), channels=3),
    "smooth": dict(mesh=(1, 2, 1), cfg=dict(interp=J.Interp.TRILINEAR)),
    "scattered": dict(mesh=(2, 2, 1), cfg=dict(scattering=True)),
    "k20": dict(mesh=(1, 4, 1), k20=True),
    "conic_lit": dict(mesh=(2, 2, 1), cfg=dict(conic=True, lighting=True),
                      cam=PF.CAM_CONIC),
    "lit_a5": dict(mesh=(2, 2, 1), cfg=dict(algorithm=J.Algorithm.TEST,
                                            lighting=True)),
    "trilinear_color": dict(mesh=(2, 2, 1),
                            cfg=dict(interp=J.Interp.TRILINEAR_COLOR)),
    "plain": dict(mesh=(2, 2, 1)),
    # density_scale 1.7 clips scaled alphas at both bounds, on the slab
    # scan's sampler; the differentiable slab unit (K4) fits it too
    "density_slab": dict(mesh=(1, 1, 4), cfg=dict(density_scale=1.7)),
}


def _scan_grads(shape, pv, ptf, pc, pcfg, target, light=None):
    """Every rank's sharded scan render and loss backward -> (images by
    rank, dcolors summed over the ranks, dlight vector summed or None)."""

    def rank(mesh):
        colors = ptf.colors.clone().requires_grad_()
        tf2 = P.TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g)
        lg = None if light is None else phong.Light(
            *(t.clone().requires_grad_() for t in light.fields()))
        img = render_dist.render_vrc_sharded(pv, tf2, pc, pcfg, mesh,
                                             mode="scan", differentiable=True,
                                             light=lg)
        loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3])
                          ** 2)
        with PF._BACKWARD:
            loss.backward()
        dl = None if lg is None else phong.light_to_vec(phong.Light(
            *(torch.zeros_like(t) if t.grad is None else t.grad
              for t in lg.fields())))
        return img.detach().numpy(), colors.grad.numpy(), dl

    out = PF._run_ranks(shape, rank)
    imgs = {c: r[0] for c, r in out.items()}
    dcol = sum(r[1] for r in out.values())
    dl = None if light is None else sum(r[2] for r in out.values()).numpy()
    return imgs, dcol, dl


def check_mesh(case, light=None):
    """Summed over the ranks, the scan units' dcolors (and dlight) equal
    jax.grad through the JAX single-device scan; every rank holds the same
    image, the scan's."""
    jv = _volume(case.get("channels", 1))
    jtf = _tf20() if case.get("k20") else J.default_transfer_function()
    jc = J.Camera.initial(position=case.get("cam", PF.CAM))
    jcfg = PF.SCENE_CFG.replace(**case.get("cfg", {}))
    target = PF._target()
    want, want_l, want_img = PF._jax_grad(jv, jtf, jc, jcfg, target, light)
    assert np.abs(want).max() > 0
    pv, ptf, pc, pcfg = PF._port(jv, jtf, jc, jcfg)
    pl = None if light is None else interop.light_from_numpy(
        *(np.asarray(getattr(light, k)) for k in PF.LIGHT_FIELDS),
        device="cpu")
    imgs, got, got_l = _scan_grads(case["mesh"], pv, ptf, pc, pcfg, target,
                                   pl)
    loose = (jcfg.algorithm is J.Algorithm.TEST
             or jcfg.interp is J.Interp.TRILINEAR)
    np.testing.assert_allclose(got, want, rtol=RTOL_LOOSE if loose else RTOL,
                               atol=ATOL)
    if light is not None:
        np.testing.assert_allclose(got_l, want_l, rtol=RTOL_LIGHT,
                                   atol=ATOL_LIGHT)
    first = imgs[(0, 0, 0)]
    for img in imgs.values():
        np.testing.assert_array_equal(img, first)
    np.testing.assert_allclose(first, want_img, rtol=0, atol=PF.TOL_VALUE)
    return pv, ptf, pc, pcfg, target


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_scan_grads_match_jax_single(name):
    """The scan segments under autograd on every rank; ``mode="fast"``
    raises for each config no differentiable unit computes, naming
    ``mode='scan'``."""
    case = MESHES[name]
    pv, ptf, pc, pcfg, _ = check_mesh(case)
    shape = case["mesh"]
    if name in ("plain", "density_slab"):
        return
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        render_dist.render_segment(pv, ptf, pc, pcfg, shape, (0, 0, 0),
                                   differentiable=True)


def test_sharded_scan_light_fit_on_conic_rays():
    """A light on conic rays (no differentiable unit takes it): dcolors and
    all ten light gradients summed over a (2, 2, 1) mesh against jax.grad
    through the JAX scan, which shades each channel with its own light
    colour, as the port's scan does."""
    jl = dataclasses.replace(jphong.default_light(),
                             color=jnp.asarray([1.0, 0.6, 0.4], jnp.float32))
    check_mesh(dict(mesh=(2, 2, 1), cfg=dict(conic=True), cam=PF.CAM_CONIC),
               light=jl)


def test_render_loss_mesh_scan_colours_density_and_light():
    """``render_loss(mesh=..., mode="scan")`` on a (1, 2, 1) mesh of a LUT
    render with a light: the TF colours, the density and the light together
    against jax.grad through the JAX scan, every rank's all-reduced
    gradients equal."""
    jv = PF._volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=PF.CAM)
    jcfg = PF.SCENE_CFG.replace(tf_lut=64)
    target = PF._target()
    jl = jphong.default_light()

    def jloss(colors, density, lvec):
        tf3 = dataclasses.replace(jtf, colors=colors.at[:, 3].mul(
            jnp.clip(density, 0.0, None)))
        img = jrender_vrc(jv, tf3, jc, jcfg, mode="fast",
                          light=jphong.light_from_vec(lvec))
        return PF._jloss(img, target)

    wc, wd, wl = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2))(
        jtf.colors, jnp.asarray(1.0, jnp.float32), jphong.light_to_vec(jl)))
    pv, ptf, pc, pcfg = PF._port(jv, jtf, jc, jcfg)
    plight = interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in PF.LIGHT_FIELDS), device="cpu")
    ptarget = torch.from_numpy(target)

    def rank(mesh):
        params = pfit.FitParams.init(ptf, light=plight)
        loss = pfit.render_loss(params, ptf, pv, pc, ptarget, pcfg, mesh,
                                mode="scan")
        with PF._BACKWARD:
            loss.backward()
        grads = [p.grad.clone() for p in params.parameters()]
        for g in grads:
            mesh.all_reduce_(g)
        return float(loss.detach()), grads

    out = PF._run_ranks((1, 2, 1), rank)
    assert len({r[0] for r in out.values()}) == 1
    g = out[(0, 0, 0)][1]
    for r in out.values():
        for a, b in zip(r[1], g):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(g[0].numpy(), wc, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(g[1]), float(wd), rtol=RTOL)
    gl = phong.light_to_vec(phong.Light(*g[2:])).numpy()
    np.testing.assert_allclose(gl, wl, rtol=RTOL_LIGHT, atol=ATOL_LIGHT)
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        pfit.render_loss(pfit.FitParams.init(ptf), ptf, pv, pc, ptarget,
                         pcfg, mesh=PF._ThreadMesh(shape=(1, 2, 1),
                                                   coords=(0, 0, 0),
                                                   groups={}), mode="fast")
