"""Port parity, the fit (diff/fit.py): a 5-step ``fit_transfer_function``
of the port on the CPU against the JAX package's (XLA scan + optax.adam)
from the same perturbed TF, one Adam step from a state carried over from
optax, a bit-identical checkpoint resume, the PNG reader the ``fit`` CLI
uses for its target, and the CLI itself."""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.diff import fit as jfit

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch.ops import phong
from volumerenderingproject_tpu_torch.parallel import mesh as pmesh
from volumerenderingproject_tpu_torch.scene.transfer_function import (
    from_text, to_text)
from volumerenderingproject_tpu_torch.utils import imageio
from volumerenderingproject_tpu_torch.utils.config import Interp, RenderConfig

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def scene():
    """The scene of tests/test_pallas_vjp.py:28-39; the target is the
    render of the default TF."""
    rng = np.random.default_rng(7)
    vol_np = rng.uniform(0.0, 255.0, size=(9, 11, 10)).astype(np.float32)
    jv = J.make_volume(vol_np)
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.35, 0.45, 0.85))
    cfg = J.RenderConfig(width=18, height=13, samples_per_ray=30)
    target = np.asarray(
        J.models.raycast.render_vrc(jv, jtf, jc, cfg, mode="fast"))
    pv = interop.volume_from_numpy(vol_np, 255.0, device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return jv, jtf, jc, cfg, target, pv, pc


def _perturbed(jtf, sign):
    """Colours of intervals 1..3 moved by 0.2 in one direction."""
    colors = np.asarray(jtf.colors).copy()
    colors[1:, :3] += np.float32(sign * 0.2)
    return colors


def _port_tf(jtf, colors):
    return interop.transfer_function_from_numpy(
        np.asarray(jtf.lower), np.asarray(jtf.upper), colors,
        np.asarray(jtf.hg_g), device="cpu")


@pytest.mark.parametrize("sign", [-1, 1])
def test_fit_matches_jax(scene, sign):
    """With -0.2 the first Adam step drives TF(0).alpha below 0 in both
    packages, so the fit also runs through the negative-alpha repair."""
    jv, jtf, jc, cfg, target, pv, pc = scene
    colors = _perturbed(jtf, sign)
    jparams, jlosses = jfit.fit_transfer_function(
        jv, jc, target, J.TransferFunction(jtf.lower, jtf.upper,
                                           jnp.asarray(colors), jtf.hg_g),
        cfg, steps=5, learning_rate=1e-2)
    pparams, plosses = pfit.fit_transfer_function(
        pv, pc, target, _port_tf(jtf, colors),
        RenderConfig.from_json(cfg.to_json()), steps=5, learning_rate=1e-2,
        device="cpu")
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)
    assert plosses[4] < plosses[0]
    np.testing.assert_allclose(pparams.tf_colors.detach().numpy(),
                               np.asarray(jparams.tf_colors), rtol=0,
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(float(pparams.density_scale.detach()),
                               float(jparams.density_scale), rtol=0,
                               atol=PARAM_ATOL)
    if sign < 0:
        assert float(jparams.tf_colors[0, 3]) < 0.0
        assert float(pparams.tf_colors[0, 3]) < 0.0


def test_fit_at_500_spr_rises_in_both_packages():
    """At 500 samples per ray and lr 1e-2 the loss jumps on the first step
    in the JAX package and in the port alike: Adam moves TF(0).alpha (0)
    by ~lr and each ray holds hundreds of interval-0 samples.  The jump
    amplifies float differences, hence rtol 1e-3 here.  At lr 3e-6 the
    same start descends at every step."""
    jv = J.ingest.synthetic.centered_sphere(100)
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(1.5, 0.4, 0.3))
    cfg = J.RenderConfig(width=8, height=8, samples_per_ray=500)
    target = np.asarray(
        J.models.raycast.render_vrc(jv, jtf, jc, cfg, mode="fast"))
    colors = _perturbed(jtf, -1)
    _, jlosses = jfit.fit_transfer_function(
        jv, jc, target, J.TransferFunction(jtf.lower, jtf.upper,
                                           jnp.asarray(colors), jtf.hg_g),
        cfg, steps=3, learning_rate=1e-2)
    pv = interop.volume_from_numpy(np.asarray(jv.data),
                                   np.asarray(jv.cal_max), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    pcfg = RenderConfig.from_json(cfg.to_json())
    ptf = _port_tf(jtf, colors)
    _, plosses = pfit.fit_transfer_function(pv, pc, target, ptf, pcfg,
                                            steps=3, learning_rate=1e-2,
                                            device="cpu")
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    assert jlosses[1] > 100 * jlosses[0] and plosses[1] > 100 * plosses[0]
    _, small = pfit.fit_transfer_function(pv, pc, target, ptf, pcfg, steps=3,
                                          learning_rate=3e-6, device="cpu")
    assert small[0] == plosses[0] and small[2] < small[1] < small[0]


def test_adam_step_from_optax_state(scene):
    """Two optax steps, their state carried over by interop, then one more
    step in each package."""
    jv, jtf, jc, cfg, target, pv, pc = scene
    colors = _perturbed(jtf, 1)
    jtf2 = J.TransferFunction(jtf.lower, jtf.upper, jnp.asarray(colors),
                              jtf.hg_g)
    opt = optax.adam(1e-2)
    params = jfit.FitParams.init(jtf2)
    state = opt.init(params)
    step = jfit.make_train_step(jtf2, cfg, opt)
    for _ in range(2):
        params, state, _ = step(params, state, jv, jc, target)
    adam = state[0]

    pparams = interop.fit_params_from_numpy(
        np.asarray(params.tf_colors), np.asarray(params.density_scale),
        device="cpu")
    optimizer = pfit.make_optimizer(pparams, 1e-2)
    interop.adam_state_from_numpy(
        optimizer, pparams, adam.count,
        (np.asarray(adam.mu.tf_colors), np.asarray(adam.mu.density_scale)),
        (np.asarray(adam.nu.tf_colors), np.asarray(adam.nu.density_scale)))
    ptf = _port_tf(jtf, colors)
    ploss = pfit.make_train_step(ptf, RenderConfig.from_json(cfg.to_json()),
                                 optimizer)(pparams, pv, pc,
                                            torch.from_numpy(target))
    params, state, jloss = step(params, state, jv, jc, target)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(pparams.tf_colors.detach().numpy(),
                               np.asarray(params.tf_colors), rtol=0,
                               atol=PARAM_ATOL)
    np.testing.assert_allclose(float(pparams.density_scale.detach()),
                               float(params.density_scale), rtol=0,
                               atol=PARAM_ATOL)
    assert optimizer.state[pparams.tf_colors]["step"] == 3


def test_checkpoint_resume_bit_identical(scene, tmp_path):
    """A fit cut after 4 steps and resumed from its checkpoint (parameters
    and optimizer state) ends bit for bit where the uninterrupted 8-step
    fit ends (the twin of tests/test_review_fixes.py:185)."""
    jv, jtf, jc, cfg, target, pv, pc = scene
    tf = _port_tf(jtf, _perturbed(jtf, 1))
    pcfg = RenderConfig.from_json(cfg.to_json())
    kw = dict(learning_rate=1e-2, device="cpu")
    straight, slosses = pfit.fit_transfer_function(pv, pc, target, tf, pcfg,
                                                   steps=8, **kw)
    ckdir = str(tmp_path / "ck")
    pfit.fit_transfer_function(pv, pc, target, tf, pcfg, steps=4,
                               checkpoint_dir=ckdir, checkpoint_every=2, **kw)
    assert pfit.latest_checkpoint_step(ckdir) == 4
    resumed, rlosses = pfit.fit_transfer_function(
        pv, pc, target, tf, pcfg, steps=8, checkpoint_dir=ckdir,
        checkpoint_every=2, resume=True, **kw)
    assert len(rlosses) == 4 and rlosses == slosses[4:]
    assert torch.equal(resumed.tf_colors, straight.tf_colors)
    assert torch.equal(resumed.density_scale, straight.density_scale)
    assert pfit.latest_checkpoint_step(ckdir) == 8
    params = pfit.load_checkpoint(ckdir, 8, device="cpu")
    assert torch.equal(params.tf_colors, straight.tf_colors)


def test_unported_fit_options_raise(scene):
    """A sharded fit that no differentiable kernel takes raises in fast
    mode, naming the scan route, which fits it (a one-rank mesh here equals
    the single-device scan route; the sharded fits the kernels take are in
    tests/test_torch_parallel_fit.py, the scan route's in
    tests/test_torch_scan_fit_sharded.py); bound fits are ported (smooth mode,
    tests/test_torch_smooth_vjp.py) and only add the bounds, light fits
    (tests/test_torch_lit_fit.py) the light's six fields as leaves."""
    _, jtf, _, cfg, target, pv, pc = scene
    tf = _port_tf(jtf, np.asarray(jtf.colors))
    bounded = pfit.FitParams.init(tf, fit_bounds=True)
    assert len(bounded.parameters()) == 4
    assert torch.equal(bounded.tf_lower, tf.lower) and bounded.tf_upper.requires_grad
    light = phong.default_light(device="cpu")
    lit = pfit.FitParams.init(tf, light=light)
    assert len(lit.parameters()) == 2 + 6
    assert all(p.is_leaf and p.requires_grad for p in lit.parameters())
    assert torch.equal(lit.light.direction, light.direction)
    assert lit.light.direction is not light.direction
    params = pfit.FitParams.init(tf)
    mesh = pmesh.Mesh(shape=(2, 2, 1), coords=(0, 0, 0), groups={})
    lut = RenderConfig.from_json(cfg.to_json()).replace(tf_lut=64)
    with pytest.raises(NotImplementedError, match="mode='scan'"):
        pfit.render_loss(params, tf, pv, pc, torch.from_numpy(target), lut,
                         mesh=mesh, mode="fast")
    one = pmesh.Mesh(shape=(1, 1, 1), coords=(0, 0, 0), groups={})
    sharded = pfit.render_loss(params, tf, pv, pc, torch.from_numpy(target),
                               lut, mesh=one, mode="scan")
    single = pfit.render_loss(params, tf, pv, pc, torch.from_numpy(target),
                              lut, mode="scan")
    np.testing.assert_allclose(float(sharded), float(single), rtol=1e-6)


# -- bound fits (smooth mode) ----------------------------------------------


@pytest.fixture(scope="module")
def smooth_scene(scene):
    """The scene in smooth mode at sharpness 40 (test_fit_params.py:181-201),
    the target the default TF's smooth render, the start its bounds moved
    by the JAX test's offsets."""
    jv, jtf, jc, cfg, _, pv, pc = scene
    cfg_s = cfg.replace(interp=J.Interp.TRILINEAR, tf_sharpness=40.0)
    target = np.asarray(J.models.raycast.render_vrc(jv, jtf, jc, cfg_s,
                                                    mode="fast"))
    lower = np.asarray(jtf.lower) + np.float32([0.0, 0.06, -0.05, 0.04])
    upper = np.asarray(jtf.upper) + np.float32([0.0, -0.06, 0.05, -0.04])
    return jv, jtf, jc, cfg_s, target, pv, pc, lower, upper


def _bounded_tfs(jtf, lower, upper):
    jt = J.TransferFunction(jnp.asarray(lower), jnp.asarray(upper),
                            jtf.colors, jtf.hg_g)
    pt = interop.transfer_function_from_numpy(
        lower, upper, np.asarray(jtf.colors), np.asarray(jtf.hg_g),
        device="cpu")
    return jt, pt


def test_bound_fit_matches_jax(smooth_scene):
    """3 smooth-mode steps with ``fit_bounds=True``: losses, bounds, colours
    and density follow the JAX package's trajectory (XLA scan + optax.adam)
    within PR 2's Adam tolerances, and the bounds move toward the truth."""
    jv, jtf, jc, cfg, target, pv, pc, lower, upper = smooth_scene
    jt, pt = _bounded_tfs(jtf, lower, upper)
    jparams, jlosses = jfit.fit_transfer_function(
        jv, jc, target, jt, cfg, steps=3, learning_rate=5e-3, fit_bounds=True)
    pparams, plosses = pfit.fit_transfer_function(
        pv, pc, target, pt, RenderConfig.from_json(cfg.to_json()), steps=3,
        learning_rate=5e-3, fit_bounds=True, device="cpu")
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)
    for name in ("tf_colors", "density_scale", "tf_lower", "tf_upper"):
        np.testing.assert_allclose(
            getattr(pparams, name).detach().numpy(),
            np.asarray(getattr(jparams, name)), rtol=0, atol=PARAM_ATOL,
            err_msg=name)
    err0 = np.abs(lower - np.asarray(jtf.lower)).mean()
    err1 = np.abs(pparams.tf_lower.detach().numpy()
                  - np.asarray(jtf.lower)).mean()
    assert err1 < err0 and plosses[2] < plosses[0]


def test_bounds_do_not_move_with_nearest_sampling(scene):
    """``fit_bounds=True`` with ``Interp.NEAREST``: the interval table has no
    bound gradient, so the bounds stay where they start (as in the JAX
    package) and the colours take the same steps as without bounds."""
    jv, jtf, jc, cfg, target, pv, pc = scene
    tf = _port_tf(jtf, _perturbed(jtf, 1))
    pcfg = RenderConfig.from_json(cfg.to_json())
    with_b, lb = pfit.fit_transfer_function(pv, pc, target, tf, pcfg,
                                            steps=2, fit_bounds=True,
                                            device="cpu")
    without, lw = pfit.fit_transfer_function(pv, pc, target, tf, pcfg,
                                             steps=2, device="cpu")
    assert torch.equal(with_b.tf_lower, tf.lower)
    assert torch.equal(with_b.tf_upper, tf.upper)
    assert lb == lw and torch.equal(with_b.tf_colors, without.tf_colors)


def test_checkpoint_with_bounds_resumes_bit_identical(smooth_scene, tmp_path):
    """A smooth bound fit cut after 2 steps and resumed from its checkpoint
    ends where the uninterrupted 4-step fit ends, bounds included
    (``test_checkpoint_roundtrip_new_fields``'s bounds)."""
    _, jtf, _, cfg, target, pv, pc, lower, upper = smooth_scene
    _, tf = _bounded_tfs(jtf, lower, upper)
    pcfg = RenderConfig.from_json(cfg.to_json())
    kw = dict(learning_rate=5e-3, fit_bounds=True, device="cpu")
    straight, slosses = pfit.fit_transfer_function(pv, pc, target, tf, pcfg,
                                                   steps=4, **kw)
    ckdir = str(tmp_path / "ck")
    pfit.fit_transfer_function(pv, pc, target, tf, pcfg, steps=2,
                               checkpoint_dir=ckdir, checkpoint_every=2, **kw)
    back = pfit.load_checkpoint(ckdir, 2, device="cpu")
    assert back.tf_lower is not None and back.tf_lower.requires_grad
    assert not torch.equal(back.tf_lower, tf.lower)
    resumed, rlosses = pfit.fit_transfer_function(
        pv, pc, target, tf, pcfg, steps=4, checkpoint_dir=ckdir,
        checkpoint_every=2, resume=True, **kw)
    assert rlosses == slosses[2:]
    for name in ("tf_colors", "density_scale", "tf_lower", "tf_upper"):
        assert torch.equal(getattr(resumed, name), getattr(straight, name))


def test_interop_fit_params_with_bounds():
    """``fit_params_from_numpy`` takes the bounds; ``adam_state_from_numpy``
    takes one moment per parameter, in ``parameters()`` order."""
    p = interop.fit_params_from_numpy(np.ones((4, 4)), 1.0, np.zeros(4),
                                      np.ones(4), device="cpu")
    assert [t.shape for t in p.parameters()] == [(4, 4), (), (4,), (4,)]
    assert all(t.requires_grad for t in p.parameters())
    opt = pfit.make_optimizer(p, 1e-2)
    mu = [np.full(t.shape, 0.5, np.float32) for t in p.parameters()]
    interop.adam_state_from_numpy(opt, p, 2, mu, mu)
    assert torch.equal(opt.state[p.tf_upper]["exp_avg"], torch.full((4,), 0.5))
    with pytest.raises(ValueError, match="one array per parameter"):
        interop.adam_state_from_numpy(opt, p, 2, mu[:2], mu[:2])


def test_cli_fit_bounds_cpu(tmp_path):
    """``fit --interp trilinear --fit-bounds --device cpu``: it exits 0, and
    the TF file it writes holds the bounds and colours that
    ``fit_transfer_function`` gives on the same inputs."""
    size = ["--width", "16", "--height", "12", "--spr", "20"]
    target_png = os.path.join(tmp_path, "target.png")
    assert cli.main(["render", "--data", "sphere", *size, "--interp",
                     "trilinear", "--device", "cpu", "--out",
                     target_png]) == 0
    tf = P.default_transfer_function(device="cpu")
    start = P.TransferFunction(tf.lower + torch.tensor([0, 0.04, -0.03, 0.02]),
                               tf.upper, tf.colors, tf.hg_g)
    tf_path = os.path.join(tmp_path, "start.txt")
    with open(tf_path, "w") as f:
        f.write(to_text(start))
    out = os.path.join(tmp_path, "fitted.txt")
    assert cli.main(["fit", "--data", "sphere", *size, "--interp",
                     "trilinear", "--fit-bounds", "--tf", tf_path, "--target",
                     target_png, "--steps", "2", "--lr", "5e-3", "--out-tf",
                     out, "--device", "cpu"]) == 0
    with open(out) as f:
        fitted = from_text(f.read(), device="cpu")
    with open(tf_path) as f:
        start = from_text(f.read(), device="cpu")
    cfg = RenderConfig(width=16, height=12, samples_per_ray=20,
                       interp=Interp.TRILINEAR)
    target = imageio.from_display(imageio.load_png(target_png))
    target = np.concatenate([target, np.ones_like(target[..., :1])], -1)
    params, _ = pfit.fit_transfer_function(
        synthetic.centered_sphere(device="cpu"), P.reset_preset(device="cpu"),
        target, start, cfg, steps=2, learning_rate=5e-3, fit_bounds=True,
        device="cpu")
    for got, want in ((fitted.lower, params.tf_lower),
                      (fitted.upper, params.tf_upper),
                      (fitted.colors, params.tf_colors)):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   rtol=1e-8)
    assert not np.array_equal(fitted.lower.numpy(), start.lower.numpy())


# -- the PNG reader ----------------------------------------------------------


def _paeth(left, up, upleft):
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    return np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up,
                                                            upleft))


def _filtered_png(img: np.ndarray, ftypes) -> bytes:
    """8-bit RGB/RGBA PNG bytes whose scanline r uses filter
    ftypes[r % len(ftypes)] (PNG spec. 9.2)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    prev = np.zeros(w * c, np.int64)
    raw = []
    for r in range(h):
        ftype, x = ftypes[r % len(ftypes)], rows[r]
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        pred = [0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][ftype]
        raw.append(np.concatenate([[ftype], (x - pred) % 256]))
        prev = x

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    idat = zlib.compress(np.concatenate(raw).astype(np.uint8).tobytes())
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
def test_decode_png_filters(tmp_path, channels, ftypes):
    rng = np.random.default_rng(len(ftypes) * 10 + ftypes[0] + channels)
    img = rng.integers(0, 256, (9, 7, channels), dtype=np.uint8)
    data = _filtered_png(img, ftypes)
    np.testing.assert_array_equal(imageio.decode_png(data), img)
    path = os.path.join(tmp_path, "x.png")
    with open(path, "wb") as f:
        f.write(data)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(
        imageio.load_png(path), img[..., :3].astype(np.float32) / 255.0)


def test_load_png_round_trip_and_from_display(tmp_path):
    """encode_png -> load_png, and from_display inverts to_display."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0.0, 1.0, (11, 6, 4)).astype(np.float32)  # [W, H, 4]
    path = os.path.join(tmp_path, "img.png")
    imageio.save_png(path, img)
    back = imageio.from_display(imageio.load_png(path))
    assert back.shape == (11, 6, 3)
    np.testing.assert_array_equal(
        back, imageio.to_uint8(img)[..., :3].astype(np.float32) / 255.0)
    disp = imageio.to_display(img)
    np.testing.assert_array_equal(imageio.from_display(disp), img)


# -- the CLI -----------------------------------------------------------------


def test_cli_fit_cpu(tmp_path):
    """``fit --device cpu`` against a rendered target from a perturbed TF
    file: it exits 0, and the TF it writes parses and equals what
    ``fit_transfer_function`` gives on the same inputs."""
    target_png = os.path.join(tmp_path, "target.png")
    size = ["--width", "20", "--height", "14", "--spr", "24"]
    assert cli.main(["render", "--data", "sphere", *size, "--device", "cpu",
                     "--out", target_png]) == 0
    tf = P.default_transfer_function(device="cpu")
    colors = tf.colors.clone()
    colors[1:, :3] -= 0.15
    start = P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)
    tf_path = os.path.join(tmp_path, "start.txt")
    with open(tf_path, "w") as f:
        f.write(to_text(start))
    out = os.path.join(tmp_path, "fitted.txt")
    assert cli.main(["fit", "--data", "sphere", *size, "--tf", tf_path,
                     "--target", target_png, "--steps", "3", "--out-tf", out,
                     "--device", "cpu"]) == 0
    with open(out) as f:
        fitted = from_text(f.read(), device="cpu")

    cfg = RenderConfig(width=20, height=14, samples_per_ray=24)
    target = imageio.from_display(imageio.load_png(target_png))
    target = np.concatenate([target, np.ones_like(target[..., :1])], -1)
    with open(tf_path) as f:
        start = from_text(f.read(), device="cpu")
    params, losses = pfit.fit_transfer_function(
        synthetic.centered_sphere(device="cpu"), P.reset_preset(device="cpu"),
        target, start, cfg, steps=3, device="cpu")
    assert losses[2] < losses[0]
    np.testing.assert_allclose(fitted.colors.numpy(),
                               params.tf_colors.detach().numpy(), rtol=1e-8)
    assert not np.array_equal(fitted.colors.numpy(), start.colors.numpy())


@pytest.mark.parametrize("flag,item", [("--fit-bounds", "mode='scan'"),
                                       ("--fit-light", "mode='scan'")])
def test_cli_fit_unported_flags_raise(flag, item, tmp_path, capsys):
    """On a lit smooth config: a light fit of a smooth render, which the
    JAX package fits only through its XLA scan, and a bound fit of a lit
    smooth render, which the smooth kernels do not compute, raise in fast
    mode naming the scan route (``--fit-light`` and ``--fit-bounds``
    themselves take the kernels: tests/test_torch_lit_fit.py,
    tests/test_torch_smooth_vjp.py); ``--mode scan`` fits them."""
    cfg = os.path.join(tmp_path, "lit_smooth.json")
    with open(cfg, "w") as f:
        f.write(RenderConfig(width=8, height=8, samples_per_ray=4,
                             interp=Interp.TRILINEAR,
                             lighting=True).to_json())
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["fit", "--config", cfg, "--device", "cpu", flag,
                  "--mode", "fast"])
    assert cli.main(["fit", "--config", cfg, "--device", "cpu", flag,
                     "--steps", "2", "--mode", "scan"]) == 0
    assert "fit: loss" in capsys.readouterr().out
