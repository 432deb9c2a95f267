"""Port parity, sharded fits (parallel/render_dist.py with
``differentiable=True``, parallel/mesh.py, diff/fit.py's mesh path) in one
process: the backward work units' plain versions against ``jax.vjp`` of the
JAX package's diff segment kernels in interpret mode, and every rank of a
mesh, each in a thread of its own joined by an in-process gather, folded as
``render_vrc_sharded`` folds what it gathers and differentiated through
``Mesh.all_gather``'s own-slice backward, their gradients summed, against
``jax.grad`` through the JAX package's single-device XLA scan.  The CUDA
kernels' segment and slab variants are held against these plain versions
on the card by chip_smoke.py (phases 3r and 7m); real gloo ranks fit in
tests/test_torch_parallel_spawn.py.

The scene is the JAX package's own (tests/test_parallel.py:15-25): an
8x10x9 volume, 16x6 pixels, 24 samples per ray, seed 7, early termination
0; the tolerances are those of its sharded-fit tests (test_parallel.py:
353-556): gradients rtol 1e-4 and atol 1e-7, light gradients rtol 2e-3."""

import collections
import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.ingest.volume import Volume as JVolume
from volumerenderingproject_tpu.models.raycast import (
    render_test as jrender_test, render_vrc as jrender_vrc)
from volumerenderingproject_tpu.ops import phong as jphong
from volumerenderingproject_tpu.ops.pallas_a5 import (
    render_test_pallas_diff_segment)
from volumerenderingproject_tpu.ops.pallas_march import (
    bake_light_grids as jbake_light_grids)
from volumerenderingproject_tpu.ops.pallas_march_vjp import (
    render_vrc_pallas_diff_segment)

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.ops import a5_vjp, march, march_vjp
from volumerenderingproject_tpu_torch.ops import phong
from volumerenderingproject_tpu_torch.parallel import mesh as pmesh
from volumerenderingproject_tpu_torch.parallel import render_dist
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
TOL_VALUE = 1e-5  # plain unit (C, T) vs interpret-mode Pallas
RTOL, ATOL = 1e-4, 1e-7  # dcolors (test_parallel.py:353-556)
# light gradients (test_parallel.py:417-454)
RTOL_LIGHT, ATOL_LIGHT = 2e-3, 1e-6
SCENE_CFG = J.RenderConfig(width=16, height=6, samples_per_ray=24)
CAM = (0.4, 0.3, 0.9)
CAM_CONIC = (0.05, 0.3, 1.2)  # the conic fan straddles dir.x = 0


def _volume():
    rng = np.random.default_rng(7)
    return J.make_volume(rng.uniform(0.0, 255.0, size=(8, 10, 9))
                         .astype(np.float32))


def _target():
    return np.random.default_rng(8).uniform(
        0.0, 1.0, (16, 6, 4)).astype(np.float32)


def _port(jv, jtf, jc, jcfg):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, ptf, pc, RenderConfig.from_json(jcfg.to_json())


def _jloss(img, target):
    return jnp.mean((img[..., :3] - target[..., :3]) ** 2)


# ---- ranks in threads, joined by an in-process gather -----------------------


class _Hub:
    """The gathers of the ranks of one mesh, each rank a thread: a rank's
    k-th gather along an axis meets the k-th gathers of the other ranks of
    its line."""

    def __init__(self):
        self.cv = threading.Condition()
        self.slots = {}
        self.calls = collections.Counter()

    def gather(self, mesh, tensor, axis):
        a = pmesh.AXES.index(axis)
        line = tuple(c for b, c in enumerate(mesh.coords) if b != a)
        with self.cv:
            n = self.calls[mesh.coords, axis]
            self.calls[mesh.coords, axis] += 1
            slot = self.slots.setdefault((axis, line, n), {})
            slot[mesh.coords[a]] = tensor.clone()
            self.cv.notify_all()
            if not self.cv.wait_for(lambda: len(slot) == mesh.shape[a],
                                    timeout=120):
                raise RuntimeError(f"gather along {axis} timed out")
            return [slot[k].clone() for k in range(mesh.shape[a])]

    def reduce(self, mesh, tensor):
        with self.cv:
            n = self.calls[mesh.coords, "reduce"]
            self.calls[mesh.coords, "reduce"] += 1
            slot = self.slots.setdefault(("reduce", n), {})
            slot[mesh.coords] = tensor.detach().clone()
            self.cv.notify_all()
            if not self.cv.wait_for(
                    lambda: len(slot) == int(np.prod(mesh.shape)),
                    timeout=120):
                raise RuntimeError("all-reduce timed out")
            total = sum(slot[c] for c in sorted(slot))
        with torch.no_grad():
            tensor.copy_(total)
        return tensor


@dataclasses.dataclass(frozen=True)
class _ThreadMesh(pmesh.Mesh):
    """``Mesh`` whose gathers and all-reduce meet the other ranks' threads
    through a ``_Hub``; the differentiable gather (``Mesh.all_gather``,
    its own-slice backward) is the package's own."""

    hub: object = None

    def _gather(self, tensor, axis):
        return self.hub.gather(self, tensor, axis)

    def all_reduce_(self, tensor):
        return self.hub.reduce(self, tensor)


# torch.func's forward-mode levels are process-wide, so two threads' light
# tangents (jvp under vmap, ops/phong.bake_tangents) must not overlap; a
# backward communicates nothing, so the ranks take turns at it
_BACKWARD = threading.Lock()


def _run_ranks(shape, fn):
    """``fn(mesh)`` on every rank of a ``shape`` mesh, one thread each ->
    {coords: result}."""
    hub = _Hub()
    coords = [pmesh.coords_of(r, shape) for r in range(int(np.prod(shape)))]
    with ThreadPoolExecutor(len(coords)) as pool:
        futs = {c: pool.submit(fn, _ThreadMesh(shape=shape, coords=c,
                                               groups={}, hub=hub))
                for c in coords}
        return {c: f.result() for c, f in futs.items()}


# ---- the JAX references -----------------------------------------------------


def _jax_grad(jv, jtf, jc, jcfg, target, light=None):
    """jax.grad of the single-device XLA scan's loss: (d colors, d light
    vector or None, the image)."""
    render = jrender_test if jcfg.algorithm is J.Algorithm.TEST else (
        jrender_vrc)
    lvec0 = None if light is None else jphong.light_to_vec(light)

    def loss(colors, lvec):
        tf2 = dataclasses.replace(jtf, colors=colors)
        kw = {} if lvec is None else dict(light=jphong.light_from_vec(lvec))
        return _jloss(render(jv, tf2, jc, jcfg, mode="fast", **kw), target)

    gc, gl = jax.grad(loss, argnums=(0, 1))(jtf.colors, lvec0)
    img = render(jv, jtf, jc, jcfg, mode="fast",
                 **({} if light is None else dict(light=light)))
    return (np.asarray(gc), None if gl is None else np.asarray(gl),
            np.asarray(img))


def _sharded_grads(shape, pv, ptf, pc, pcfg, target, light=None):
    """Every rank's sharded render and loss backward -> (images by rank,
    dcolors summed over the ranks, dlight vector summed or None)."""

    def rank(mesh):
        colors = ptf.colors.clone().requires_grad_()
        tf2 = P.TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g)
        lg = None if light is None else phong.Light(
            *(t.clone().requires_grad_() for t in light.fields()))
        img = render_dist.render_vrc_sharded(pv, tf2, pc, pcfg, mesh,
                                             differentiable=True, light=lg)
        loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3])
                          ** 2)
        with _BACKWARD:
            loss.backward()
        dl = None if lg is None else phong.light_to_vec(
            phong.Light(*(t.grad for t in lg.fields())))
        return img.detach().numpy(), colors.grad.numpy(), dl

    out = _run_ranks(shape, rank)
    imgs = {c: r[0] for c, r in out.items()}
    dcol = sum(r[1] for r in out.values())
    dl = None if light is None else sum(r[2] for r in out.values()).numpy()
    return imgs, dcol, dl


# ---- the backward work units' plain versions vs interpret-mode Pallas -------


UNITS = {
    "k4_segment": dict(unit=dict(x_offset=4, local_width=8, s_start=5,
                                 s_count=11)),
    "k4_segment_baked": dict(unit=dict(x_offset=8, local_width=8, s_start=0,
                                       s_count=13), cfg=dict(lighting=True)),
    "k4_slab": dict(unit=dict(x_offset=0, local_width=16, s_start=3,
                              s_count=21, x0=2, slab_x=4)),
    "k4_slab_baked": dict(unit=dict(x_offset=8, local_width=8, s_start=0,
                                    s_count=24, x0=4, slab_x=4),
                          cfg=dict(lighting=True, gradient_filter="sobel")),
    "k6_segment": dict(unit=dict(x_offset=6, local_width=5, s_start=7,
                                 s_count=13),
                       cfg=dict(algorithm=J.Algorithm.TEST)),
}


@pytest.mark.parametrize("name", sorted(UNITS))
def test_unit_backward_matches_pallas_interpret(name):
    """A unit's (C, T) and dcolors under seeded cotangents (gC, gT)."""
    case = UNITS[name]
    jv = _volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAM)
    jcfg = SCENE_CFG.replace(**case.get("cfg", {}))
    u = dict(case["unit"])
    rng = np.random.default_rng(9)
    g_c = rng.normal(0, 1, (u["local_width"], 6, 3)).astype(np.float32) / 96
    g_t = rng.normal(0, 1, (u["local_width"], 6, 1)).astype(np.float32) / 96
    a5_unit = jcfg.algorithm is J.Algorithm.TEST

    def jfn(colors):
        tf2 = dataclasses.replace(jtf, colors=colors)
        if a5_unit:
            return render_test_pallas_diff_segment(jv, tf2, jc, jcfg,
                                                   interpret=True, **u)
        if "slab_x" not in u:
            return render_vrc_pallas_diff_segment(jv, tf2, jc, jcfg,
                                                  interpret=True, **u)
        x0, n = u["x0"], u["slab_x"]
        slab = JVolume(data=jv.data[x0:x0 + n], cal_max=jv.cal_max,
                       cal_min=jv.cal_min, pixdim=jv.pixdim, dims=jv.dims,
                       channels=1)
        grids = None
        if jcfg.lighting:  # the whole bake, cropped (render_dist does it
            # with a halo-extended slab; the mesh tests below hold that)
            grids = tuple(g[x0:x0 + n] for g in jbake_light_grids(
                jv.data, jcfg, jphong.default_light(), -jc.front))
        return render_vrc_pallas_diff_segment(slab, tf2, jc, jcfg,
                                              interpret=True,
                                              baked_grids=grids, **u)

    (wc, wt), vjp = jax.vjp(jfn, jtf.colors)
    (wd,) = vjp((jnp.asarray(g_c), jnp.asarray(g_t)))
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    if a5_unit:
        a, _ = a5_vjp.prepare_a5_diff(pv, ptf, pc, pcfg, segment=True, **u)
        c, t = a5_vjp._forward(a)
        d = a5_vjp.march_a5_bwd_plain(a, torch.from_numpy(g_c),
                                      torch.from_numpy(g_t[..., 0]))
    else:
        a, _ = march_vjp.prepare_diff(pv, ptf, pc, pcfg, segment=True, **u)
        assert a.segment and a.ids.shape[0] == u.get("slab_x", 8)
        assert (a.mgrid is not None) == bool(jcfg.lighting)
        c, t = march_vjp._forward(a)
        d = march_vjp.march_bwd_plain(a, torch.from_numpy(g_c),
                                      torch.from_numpy(g_t[..., 0]))
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=0,
                               atol=TOL_VALUE)
    np.testing.assert_allclose(t.numpy(), np.asarray(wt), rtol=0,
                               atol=TOL_VALUE)
    assert np.abs(np.asarray(wd)).max() > 0
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=RTOL,
                               atol=ATOL)


# ---- every rank of a mesh vs jax.grad through the single-device scan --------


MESHES = {
    "rays_samples": dict(mesh=(2, 2, 1)),
    "rays": dict(mesh=(4, 1, 1)),
    "samples": dict(mesh=(1, 4, 1)),
    "volume": dict(mesh=(1, 1, 4)),
    "rays_volume": dict(mesh=(2, 1, 2)),
    "samples_volume": dict(mesh=(1, 2, 2)),
    # every ray picks its own slab order (fold_volume's torch.where)
    "conic_volume": dict(mesh=(1, 1, 8), cam=CAM_CONIC, cfg=dict(conic=True)),
    "lit_rays_samples": dict(mesh=(2, 2, 1), cfg=dict(lighting=True)),
    # lit slabs: the whole volume's bake cropped to each slab
    "lit_slabs_central": dict(mesh=(1, 1, 4), cfg=dict(lighting=True)),
    "lit_slabs_sobel": dict(mesh=(1, 1, 4), cfg=dict(
        lighting=True, gradient_filter="sobel")),
    "lit_slabs_presmoothed": dict(mesh=(1, 1, 4), cfg=dict(
        lighting=True, presmooth_sigma=1.0)),
    "a5_rays_samples": dict(mesh=(2, 2, 1),
                            cfg=dict(algorithm=J.Algorithm.TEST)),
    "a5_samples": dict(mesh=(1, 4, 1), cfg=dict(algorithm=J.Algorithm.TEST)),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_grads_match_jax_single(name):
    """Summed over the ranks, dcolors equal jax.grad through the JAX
    single-device scan; every rank holds the same image, which equals the
    sharded render's at differentiable=False (eps 0) and the scan's."""
    case = MESHES[name]
    jv = _volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=case.get("cam", CAM))
    jcfg = SCENE_CFG.replace(**case.get("cfg", {}))
    target = _target()
    want, _, want_img = _jax_grad(jv, jtf, jc, jcfg, target)
    assert np.abs(want).max() > 0
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    imgs, got, _ = _sharded_grads(case["mesh"], pv, ptf, pc, pcfg, target)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    first = imgs[(0, 0, 0)]
    for img in imgs.values():
        np.testing.assert_array_equal(img, first)
    np.testing.assert_allclose(first, want_img, rtol=0, atol=TOL_VALUE)
    if not pcfg.lighting or case["mesh"][2] == 1:
        fwd = _run_ranks(case["mesh"], lambda mesh: render_dist.
                         render_vrc_sharded(pv, ptf, pc, pcfg, mesh).numpy())
        np.testing.assert_array_equal(fwd[(0, 0, 0)], first)


def test_colours_density_and_light_match_jax_single():
    """diff/fit.render_loss on a (2, 2, 1) mesh: TF colours, the density and
    the 10 light parameters together (tests/test_fit_params.py:285-337), the
    light's colour components symmetrised as the lit core's mean colour
    gives them (test_parallel.py:417-454)."""
    from volumerenderingproject_tpu_torch.diff import fit as pfit

    jv = _volume()
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=CAM)
    jcfg = SCENE_CFG.replace(lighting=True)
    target = _target()
    jl = jphong.default_light()

    def jloss(colors, density, lvec):
        tf3 = dataclasses.replace(jtf, colors=colors.at[:, 3].mul(
            jnp.clip(density, 0.0, None)))
        img = jrender_vrc(jv, tf3, jc, jcfg, mode="fast",
                          light=jphong.light_from_vec(lvec))
        return _jloss(img, target)

    wc, wd, wl = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2))(
        jtf.colors, jnp.asarray(1.0, jnp.float32), jphong.light_to_vec(jl)))
    pv, ptf, pc, pcfg = _port(jv, jtf, jc, jcfg)
    plight = interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS), device="cpu")
    ptarget = torch.from_numpy(target)

    def rank(mesh):
        params = pfit.FitParams.init(ptf, light=plight)
        loss = pfit.render_loss(params, ptf, pv, pc, ptarget, pcfg, mesh)
        with _BACKWARD:
            loss.backward()
        grads = [p.grad.clone() for p in params.parameters()]
        for g in grads:
            mesh.all_reduce_(g)
        return float(loss.detach()), grads

    out = _run_ranks((2, 2, 1), rank)
    losses = {r[0] for r in out.values()}
    assert len(losses) == 1
    g = out[(0, 0, 0)][1]
    for r in out.values():  # the all-reduce leaves every rank the same sum
        for a, b in zip(r[1], g):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(g[0].numpy(), wc, rtol=RTOL, atol=ATOL)
    assert abs(float(wd)) > 0
    np.testing.assert_allclose(float(g[1]), float(wd), rtol=RTOL)
    gl = phong.light_to_vec(phong.Light(*g[2:])).numpy()
    keep = [0, 1, 2, 6, 7, 8, 9]
    np.testing.assert_allclose(gl[keep], wl[keep], rtol=RTOL_LIGHT,
                               atol=ATOL_LIGHT)
    np.testing.assert_allclose(gl[3:6], np.full(3, wl[3:6].mean()),
                               rtol=RTOL_LIGHT, atol=ATOL_LIGHT)
