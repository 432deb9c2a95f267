"""Port parity, lit, LUT and light-parameter fits (ops/march_vjp.py,
ops/phong.py, diff/fit.py): the backward march's baked-light, LUT and
LUT + baked-light variants and the light gradient through their plain
versions on the CPU, against the JAX package's Pallas kernels in interpret
mode and ``jax.grad`` through its XLA scan, on the scene of
tests/test_fit_params.py:40-49; the bake's tangents against ``jax.jvp``;
lit and light fits against the JAX package's; checkpoints with a light;
the CLI's ``fit --fit-light``; and what still raises.  The CUDA kernels
themselves (csrc/march_bwd.cu) are held against ``march_bwd_plain`` on the
card by chip_smoke.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit
from volumerenderingproject_tpu.models.raycast import render_vrc as jrender_vrc
from volumerenderingproject_tpu.ops import phong as jphong
from volumerenderingproject_tpu.ops.pallas_march import (
    bake_light_grids as jbake_light_grids)
from volumerenderingproject_tpu.ops.pallas_march_vjp import (
    render_vrc_pallas_diff,
)

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ops import conv3d, march, march_vjp, phong
from volumerenderingproject_tpu_torch.scene.transfer_function import from_text
from volumerenderingproject_tpu_torch.utils.config import (
    Algorithm, Interp, RenderConfig)

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TF_FIELDS = ("lower", "upper", "colors", "hg_g")
LIGHT_FIELDS = ("direction", "color", "ambient", "diffuse", "specular",
                "shininess")
TOL = 2e-5  # values (benchmarks/onchip_parity.py)
# plain versions vs the interpret-mode Pallas backward (the same two-pass
# arithmetic, another float order in the reductions)
PALLAS_RTOL, PALLAS_ATOL_SHARE = 1e-4, 1e-4


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_fit_params.py:40-49."""
    rng = np.random.default_rng(11)
    vol_np = rng.uniform(0.0, 255.0, size=(9, 11, 10)).astype(np.float32)
    jv = J.make_volume(vol_np)
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30)
    target = rng.uniform(0.0, 1.0, size=(18, 13, 4)).astype(np.float32)
    return jv, jtf, jc, cfg, target


def _port_scene(jv, jc):
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return pv, pc


def _port_tf(jtf):
    return interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in TF_FIELDS), device="cpu")


def _port_light(jl):
    return interop.light_from_numpy(
        *(np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS), device="cpu")


def _port_cfg(cfg):
    return RenderConfig.from_json(cfg.to_json())


def _jloss(img, target):
    return jnp.mean((img[..., :3] - target[..., :3]) ** 2)


def _port_colour_grad(jv, jtf, jc, cfg, target, light=None):
    """(loss, dL/dcolors, image) through ``render_vrc_diff`` on the CPU."""
    pv, pc = _port_scene(jv, jc)
    ptf = _port_tf(jtf)
    colors = ptf.colors.clone().requires_grad_()
    img = march_vjp.render_vrc_diff(
        pv, P.TransferFunction(ptf.lower, ptf.upper, colors, ptf.hg_g), pc,
        _port_cfg(cfg), device="cpu", light=light)
    loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3]) ** 2)
    loss.backward()
    return float(loss.detach()), colors.grad.numpy(), img.detach().numpy()


def _jax_colour_grad(jv, jtf, jc, cfg, target, render):
    def loss(colors):
        tf2 = dataclasses.replace(jtf, colors=colors)
        return _jloss(render(jv, tf2, jc, cfg), target)

    lx, gx = jax.value_and_grad(loss)(jtf.colors)
    return float(lx), np.asarray(gx)


def _pallas(jv, tf2, jc, cfg):
    return render_vrc_pallas_diff(jv, tf2, jc, cfg, interpret=True)


def _scan(jv, tf2, jc, cfg):
    return jrender_vrc(jv, tf2, jc, cfg, mode="fast")


@pytest.mark.parametrize("variant,kw,scan_tol", [
    ("baked", dict(lighting=True), dict(rtol=1e-3, atol=1e-6)),
    ("lut", dict(tf_lut=256), dict(rtol=1e-4, atol_share=1e-4)),
    ("lut_baked", dict(tf_lut=64, lighting=True),
     dict(rtol=1e-4, atol_share=1e-4)),
])
def test_k4_variant_matches_pallas_and_scan(scene, variant, kw, scan_tol):
    """The variant's dcolors against the interpret-mode Pallas backward and
    ``jax.grad`` through the XLA scan, at the JAX tests' tolerances
    (tests/test_pallas_vjp.py:214-240, 366-398)."""
    jv, jtf, jc, cfg0, target = scene
    cfg = cfg0.replace(**kw)
    pv, pc = _port_scene(jv, jc)
    args, _ = march_vjp.prepare_diff(pv, _port_tf(jtf), pc, _port_cfg(cfg))
    assert march.variant(args) == variant
    lp, gp, img = _port_colour_grad(jv, jtf, jc, cfg, target)
    np.testing.assert_allclose(img, np.asarray(_scan(jv, jtf, jc, cfg)),
                               rtol=0, atol=TOL)
    l_pal, g_pal = _jax_colour_grad(jv, jtf, jc, cfg, target, _pallas)
    np.testing.assert_allclose(lp, l_pal, rtol=1e-5)
    np.testing.assert_allclose(gp, g_pal, rtol=PALLAS_RTOL,
                               atol=PALLAS_ATOL_SHARE * np.abs(g_pal).max())
    l_x, g_x = _jax_colour_grad(jv, jtf, jc, cfg, target, _scan)
    np.testing.assert_allclose(lp, l_x, rtol=1e-5)
    atol = scan_tol.get("atol", scan_tol.get("atol_share", 0.0)
                        * np.abs(g_x).max())
    np.testing.assert_allclose(gp, g_x, rtol=scan_tol["rtol"], atol=atol)
    assert np.abs(gp).max() > 0.0


def _ulp_point(n: int) -> int:
    """A grid point i of an n-entry LUT where to_lut's point
    f32(i) * f32(1/(n-1)) lies above the IEEE quotient i / (n-1)."""
    i = np.arange(n, dtype=np.float32)
    grid = i * (np.float32(1) / np.float32(n - 1))
    quot = i / np.float32(n - 1)
    return int(np.nonzero(grid > quot)[0][len(np.nonzero(grid > quot)[0]) // 2])


def test_lut_bound_within_an_ulp_of_a_grid_point(scene):
    """A TF bound on a LUT grid point that the IEEE quotient idx / (N - 1)
    puts an ulp below it: the LUT entry takes the bound's interval (to_lut
    classifies its own grid), and so does its gradient (``itv`` is built
    from that grid), as ``jax.grad`` through the XLA LUT scan gives.  The
    interpret-mode Pallas backward re-classifies idx / (N - 1); on the CPU
    XLA turns that division by a constant into the same product, so it
    agrees here too."""
    jv, _, jc, cfg0, target = scene
    n = 256
    i = _ulp_point(n)
    point = np.float32(i) * (np.float32(1) / np.float32(n - 1))
    assert np.float32(i) / np.float32(n - 1) < point
    # voxels of index i and some on each side; the rest in interval 0
    rng = np.random.default_rng(3)
    vals = (np.float32(i) + rng.integers(-3, 4, (9, 11, 10))) / np.float32(
        n - 1) * np.float32(255.0)
    jv = J.make_volume(vals.astype(np.float32))
    text = (f"empty 0 1 0.1 0.1 0.1 0.05\n"
            f"edge {float(point)!r} 1 0.9 0.4 0.2 0.3\n")
    ptf = from_text(text, device="cpu")
    jtf = J.TransferFunction(*(jnp.asarray(getattr(ptf, k).numpy())
                               for k in TF_FIELDS))
    idx = torch.round(P.make_volume(vals.astype(np.float32), device="cpu")
                      .data / 255.0 * (n - 1))
    assert bool((idx == i).any())
    assert int(ptf.lut_intervals(n)[i]) == 1  # entry i: the edge interval
    cfg = cfg0.replace(tf_lut=n)
    lp, gp, _ = _port_colour_grad(jv, jtf, jc, cfg, target)
    l_x, g_x = _jax_colour_grad(jv, jtf, jc, cfg, target, _scan)
    np.testing.assert_allclose(lp, l_x, rtol=1e-5)
    np.testing.assert_allclose(gp, g_x, rtol=1e-4,
                               atol=1e-4 * np.abs(g_x).max())
    assert np.abs(gp[1]).max() > 0.0
    _, g_pal = _jax_colour_grad(jv, jtf, jc, cfg, target, _pallas)
    np.testing.assert_allclose(gp, g_pal, rtol=PALLAS_RTOL,
                               atol=PALLAS_ATOL_SHARE * np.abs(g_pal).max())


def _light_vec_grad_port(jv, jtf, jc, cfg, target, jl):
    pv, pc = _port_scene(jv, jc)
    light = _port_light(jl)
    leaves = [t.clone().requires_grad_() for t in light.fields()]
    img = march_vjp.render_vrc_diff(pv, _port_tf(jtf), pc, _port_cfg(cfg),
                                    device="cpu", light=phong.Light(*leaves))
    loss = torch.mean((img[..., :3] - torch.from_numpy(target)[..., :3]) ** 2)
    loss.backward()
    return torch.cat([t.grad.reshape(-1) for t in leaves]).numpy()


def test_light_grad_matches_fused_core_and_scan(scene):
    """dL/d(light vector) against JAX's light-differentiable fused core
    (``_make_lit_core``, interpret mode, rtol 1e-4) and ``jax.grad``
    through the XLA Phong scan (tests/test_fit_params.py:68-97)."""
    jv, jtf, jc, cfg, target = scene
    jl = jphong.default_light()
    g = _light_vec_grad_port(jv, jtf, jc, cfg, target, jl)

    def loss_pallas(lvec):
        return _jloss(render_vrc_pallas_diff(
            jv, jtf, jc, cfg, interpret=True,
            light=jphong.light_from_vec(lvec)), target)

    def loss_xla(lvec):
        return _jloss(jrender_vrc(jv, jtf, jc, cfg, mode="fast",
                                  light=jphong.light_from_vec(lvec)), target)

    lvec = jphong.light_to_vec(jl)
    g_p = np.asarray(jax.jit(jax.grad(loss_pallas))(lvec))
    g_x = np.asarray(jax.grad(loss_xla)(lvec))
    np.testing.assert_allclose(g, g_p, rtol=1e-4,
                               atol=1e-4 * np.abs(g_p).max())
    keep = [0, 1, 2, 6, 7, 8, 9]
    np.testing.assert_allclose(g[keep], g_x[keep], rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(g[3:6].sum(), g_x[3:6].sum(), rtol=2e-3,
                               atol=2e-5)
    assert np.abs(g).max() > 1e-6


def test_light_color_grads_symmetric(scene):
    """The bake collapses the light colour to its channel mean, so the three
    colour gradients are equal (tests/test_fit_params.py:100-116)."""
    jv, jtf, jc, cfg, target = scene
    g = _light_vec_grad_port(jv, jtf, jc, cfg, target,
                             jphong.default_light())
    np.testing.assert_allclose(g[3], g[4], rtol=1e-6)
    np.testing.assert_allclose(g[3], g[5], rtol=1e-6)
    assert g[3] != 0.0


def test_tf_color_grads_with_light(scene):
    """Colour gradients of a render shaded with an explicit light match
    ``jax.grad`` through the XLA scan (tests/test_fit_params.py:119-140)."""
    jv, jtf, jc, cfg, target = scene
    jl = jphong.default_light()
    _, gp, img = _port_colour_grad(jv, jtf, jc, cfg, target,
                                   light=_port_light(jl))
    np.testing.assert_allclose(
        img, np.asarray(jrender_vrc(jv, jtf, jc, cfg, mode="fast", light=jl)),
        rtol=0, atol=TOL)
    _, g_x = _jax_colour_grad(
        jv, jtf, jc, cfg, target,
        lambda v, tf2, c, k: jrender_vrc(v, tf2, c, k, mode="fast", light=jl))
    np.testing.assert_allclose(gp, g_x, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("filt,sigma", [("central", 0.0), ("sobel", 0.0),
                                        ("central", 1.0)])
def test_bake_tangents_match_jax_jvp(scene, filt, sigma):
    """``bake_tangents`` against ``jax.jvp`` of the JAX package's mean-colour
    bake (pallas_march_vjp.py:1129-1135), one one-hot tangent per light
    parameter, within 1e-6 of the largest value.  JAX is evaluated op by
    op: under jit XLA contracts the normals' multiply-adds into fused
    multiply-adds, which moves |n.h| by an ulp at some voxels and
    |n.h|^16 by up to 1.7e-6."""
    jv, _, jc, _, _ = scene
    data = np.array(jv.data)
    view = -np.asarray(jc.front)
    lvec = np.asarray([0.5, 1.0, 0.75, 1.0, 0.9, 0.8, 0.35, 0.55, 0.25,
                       16.0], np.float32)
    jcfg = J.RenderConfig(gradient_filter=filt, presmooth_sigma=sigma)

    def stage(v):
        lg = jphong.light_from_vec(v)
        lg = dataclasses.replace(
            lg, color=jnp.full((3,), jnp.mean(lg.color), jnp.float32))
        return jbake_light_grids(jnp.asarray(data), jcfg, lg,
                                 jnp.asarray(view))

    with jax.disable_jit():
        tangents = [jax.jvp(stage, (jnp.asarray(lvec),),
                            (jnp.asarray(np.eye(10, dtype=np.float32)[p]),))[1]
                    for p in range(phong.N_LIGHT_PARAMS)]
        jm, js = stage(jnp.asarray(lvec))
    want_m = np.stack([np.asarray(m) for m, _ in tangents])
    want_s = np.stack([np.asarray(s) for _, s in tangents])
    dm, ds = phong.bake_tangents(torch.from_numpy(data), _port_cfg(jcfg),
                                 torch.from_numpy(lvec),
                                 torch.from_numpy(view))
    assert dm.shape == ds.shape == (10,) + data.shape
    np.testing.assert_allclose(dm.numpy(), want_m, rtol=0,
                               atol=1e-6 * np.abs(want_m).max())
    np.testing.assert_allclose(ds.numpy(), want_s, rtol=0,
                               atol=1e-6 * np.abs(want_s).max())
    grad = conv3d.gradient_field(torch.from_numpy(data), filt, sigma)
    m, s = phong.bake_light_vec(grad, torch.from_numpy(lvec),
                                torch.from_numpy(view))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-6)


def _start_light(jl):
    """The JAX light-recovery test's start: ambient 0.7, diffuse 0.2
    (tests/test_fit_params.py:166-170)."""
    return dataclasses.replace(jl, ambient=jnp.asarray(0.7, jnp.float32),
                               diffuse=jnp.asarray(0.2, jnp.float32))


@pytest.mark.parametrize("kind", ["lit", "lut", "light"])
def test_fit_matches_jax(scene, kind):
    """3 steps of a lit colour fit, a LUT colour fit and a light fit (from
    the JAX light-recovery test's start, against the render of the default
    light) against the JAX package's ``fit_transfer_function`` (its XLA
    scan on the CPU): losses rtol 1e-4, parameters within 1e-5 (the light
    colour aside, see below)."""
    jv, jtf, jc, cfg, _ = scene
    light = None
    if kind == "light":
        jl = jphong.default_light()
        target = np.asarray(jrender_vrc(jv, jtf, jc, cfg, mode="fast",
                                        light=jl))
        light = _start_light(jl)
        lr = 2e-2
    else:
        cfg = cfg.replace(**(dict(lighting=True) if kind == "lit"
                             else dict(tf_lut=256)))
        target = np.asarray(jrender_vrc(jv, jtf, jc, cfg, mode="fast"))
        colors = np.asarray(jtf.colors).copy()
        colors[1:, :3] += np.float32(0.2)
        jtf = dataclasses.replace(jtf, colors=jnp.asarray(colors))
        lr = 1e-2
    jparams, jlosses = jfit.fit_transfer_function(
        jv, jc, jnp.asarray(target), jtf, cfg, steps=3, learning_rate=lr,
        light=light)
    pv, pc = _port_scene(jv, jc)
    pparams, plosses = pfit.fit_transfer_function(
        pv, pc, target, _port_tf(jtf), _port_cfg(cfg), steps=3,
        learning_rate=lr, device="cpu",
        light=None if light is None else _port_light(light))
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(pparams.tf_colors.detach().numpy(),
                               np.asarray(jparams.tf_colors), rtol=0,
                               atol=1e-5)
    if light is not None:
        # the JAX fit on the CPU runs its XLA scan, which shades each channel
        # with its own light colour, so its three colour components part
        # after the first step; the fused lit core (the JAX package's route
        # on a TPU) and the port keep them equal
        got = phong.light_to_vec(pparams.light).detach().numpy()
        want = np.asarray(jphong.light_to_vec(jparams.light))
        keep = [0, 1, 2, 6, 7, 8, 9]
        np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=1e-5)
        assert got[3] == got[4] == got[5]
        assert abs(float(pparams.light.ambient.detach()) - 0.7) > 1e-3
    else:
        assert plosses[-1] < plosses[0]


def test_light_fit_descends_toward_the_true_light(scene):
    """The first 25 steps of the JAX light-recovery case
    (tests/test_fit_params.py:158-178: ambient 0.7 and diffuse 0.2 toward
    the default light, lr 2e-2) through the plain versions: the loss
    halves and ambient moves toward 0.35.  The full 150 steps, with the JAX
    test's criteria, run on the card (chip_smoke.py)."""
    jv, jtf, jc, cfg, _ = scene
    pv, pc = _port_scene(jv, jc)
    tf = _port_tf(jtf)
    pcfg = _port_cfg(cfg)
    true = phong.default_light(device="cpu")
    target = P.render(pv, tf, pc, pcfg, mode="scan", device="cpu", light=true)
    params, losses = pfit.fit_transfer_function(
        pv, pc, target, tf, pcfg, steps=25, learning_rate=2e-2,
        device="cpu", light=_port_light(_start_light(jphong.default_light())))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    err0 = abs(0.7 - float(true.ambient))
    err = abs(float(params.light.ambient.detach()) - float(true.ambient))
    assert err < 0.8 * err0, (err, err0)


def test_light_fit_checkpoint_resumes_bit_identical(scene, tmp_path):
    """A light fit resumed from its step-2 checkpoint continues bit for
    bit; the light is stored under the JAX checkpoint's field names."""
    jv, jtf, jc, cfg, target = scene
    pv, pc = _port_scene(jv, jc)
    tf, pcfg = _port_tf(jtf), _port_cfg(cfg)
    light = _port_light(_start_light(jphong.default_light()))
    kw = dict(steps=4, learning_rate=2e-2, device="cpu", light=light)
    straight, slosses = pfit.fit_transfer_function(pv, pc, target, tf, pcfg,
                                                   **kw)
    ckdir = str(tmp_path / "ck")
    pfit.fit_transfer_function(pv, pc, target, tf, pcfg, checkpoint_dir=ckdir,
                               checkpoint_every=2, **dict(kw, steps=2))
    state = torch.load(f"{ckdir}/step_2.pt", weights_only=True)
    assert sorted(state["params"]["light"]) == sorted(LIGHT_FIELDS)
    resumed, rlosses = pfit.fit_transfer_function(
        pv, pc, target, tf, pcfg, checkpoint_dir=ckdir, resume=True, **kw)
    assert rlosses == slosses[2:]
    for a, b in zip(resumed.parameters(), straight.parameters()):
        assert torch.equal(a, b)
    loaded = pfit.load_checkpoint(ckdir, 2, device="cpu")
    assert loaded.light.ambient.requires_grad
    assert len(loaded.parameters()) == 2 + 6


def test_interop_fit_params_with_light():
    jl = jphong.default_light()
    params = interop.fit_params_from_numpy(
        np.zeros((4, 4), np.float32), 1.0,
        light={k: np.asarray(getattr(jl, k)) for k in LIGHT_FIELDS},
        device="cpu")
    assert len(params.parameters()) == 8
    np.testing.assert_array_equal(
        phong.light_to_vec(params.light).detach().numpy(),
        np.asarray(jphong.light_to_vec(jl)))
    assert all(p.requires_grad and p.is_leaf for p in params.parameters())


def test_cli_fit_light_cpu(tmp_path, capsys):
    """``fit --fit-light --lighting`` on the CPU fits from the default
    light, prints the fitted light and writes a TF file that parses."""
    out = str(tmp_path / "fitted.txt")
    assert cli.main(["fit", "--data", "sphere", "--width", "20", "--height",
                     "14", "--spr", "24", "--steps", "3", "--fit-light",
                     "--lighting", "--gradient-filter", "sobel", "--out-tf",
                     out, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    line = [s for s in printed.splitlines() if s.startswith("fitted light:")]
    assert len(line) == 1
    vec = eval(line[0].split(":", 1)[1])  # a list of 10 floats
    assert len(vec) == phong.N_LIGHT_PARAMS
    with open(out) as f:
        assert from_text(f.read(), device="cpu").num_intervals == 4


@pytest.mark.parametrize("cfg_kw,light_kw,item", [
    (dict(scattering=True), {}, "mode='scan'"),
    (dict(lighting=True, conic=True), {}, "mode='scan'"),
    (dict(tf_lut=256), {}, "mode='scan'"),
    (dict(algorithm=Algorithm.TEST), {}, "mode='scan'"),
    (dict(interp=Interp.TRILINEAR), {}, "mode='scan'"),
    (dict(), dict(color=[1.0, 0.5, 0.5]), "mode='scan'"),
])
def test_unported_light_fits_raise(scene, cfg_kw, light_kw, item):
    """Light fits the fused marches do not compute raise in fast mode,
    naming ``mode='scan'``, and none falls back to another route; the scan
    route fits them (its gradients against the JAX package's:
    tests/test_torch_scan_fit.py)."""
    jv, jtf, jc, cfg, target = scene
    pv, pc = _port_scene(jv, jc)
    pcfg = _port_cfg(cfg).replace(**cfg_kw)
    light = phong.default_light(device="cpu")
    if light_kw:
        light = dataclasses.replace(
            light, color=torch.tensor(light_kw["color"]))
    tf = _port_tf(jtf)
    assert not march_vjp.diff_light_eligible(pv, tf, pcfg, light)
    with pytest.raises(NotImplementedError, match=item):
        pfit.fit_transfer_function(pv, pc, target, tf, pcfg, steps=1,
                                   device="cpu", light=light, mode="fast")
    params, losses = pfit.fit_transfer_function(
        pv, pc, target, tf, pcfg, steps=1, device="cpu", light=light,
        mode="scan")
    assert np.isfinite(losses[0])
    assert not torch.equal(params.light.direction, light.direction)


def test_light_fit_eligible_and_16_intervals(scene):
    jv, jtf, jc, cfg, target = scene
    pv, pc = _port_scene(jv, jc)
    tf = _port_tf(jtf)
    assert march_vjp.diff_light_eligible(pv, tf, _port_cfg(cfg))
    assert march_vjp.diff_light_eligible(
        pv, tf, _port_cfg(cfg).replace(lighting=True))
    k = 17
    tf17 = P.TransferFunction(torch.zeros(k), torch.ones(k),
                              torch.full((k, 4), 0.1), torch.zeros(k))
    assert not march_vjp.diff_light_eligible(pv, tf17, _port_cfg(cfg))
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        pfit.fit_transfer_function(pv, pc, target, tf17, _port_cfg(cfg),
                                   steps=1, device="cpu",
                                   light=phong.default_light(device="cpu"),
                                   mode="fast")
    _, losses = pfit.fit_transfer_function(
        pv, pc, target, tf17, _port_cfg(cfg), steps=1, device="cpu",
        light=phong.default_light(device="cpu"), mode="scan")
    assert np.isfinite(losses[0])
