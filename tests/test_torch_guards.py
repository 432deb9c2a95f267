"""Guards of the port: it imports neither JAX nor the JAX package, it never
falls back to the CPU by itself, its TF32 switches are off, and its CLI
writes the PNG of what ``render`` returns."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.diff import fit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ingest import synthetic
from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.harness import camera_recovery, server
from volumerenderingproject_tpu_torch.ops import (a5_vjp, conv3d, march_vjp,
                                                  phong, smooth_vjp)
from volumerenderingproject_tpu_torch.utils import imageio, texture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATION = """
import importlib, pkgutil, sys
import volumerenderingproject_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
for name in ("ops.march", "ops.march_vjp", "ops.a5", "ops.a5_vjp",
             "ops.conv3d", "ops.phong", "ops.smooth", "ops.smooth_vjp",
             "diff.fit", "interop", "harness.cli", "utils.imageio",
             "models.point_splat", "models.debug_colors",
             "scene.voxel_colors", "native", "native.build", "ingest.vvi",
             "harness.goldens", "harness.profiling", "parallel.dryrun",
             "harness.server", "harness.viewer", "harness.camera_recovery",
             "utils.texture", "accel", "accel.pyramid", "ops.composite"):
    assert pkg.__name__ + "." + name in sys.modules, name
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "volumerenderingproject_tpu"
             or k.startswith("volumerenderingproject_tpu."))
assert not bad, bad
print("isolated", len([k for k in sys.modules if k.startswith(pkg.__name__)]))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("isolated")


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: P.make_volume(np.zeros((2, 2, 2), np.float32)),
    lambda: synthetic.centered_sphere(4),
    lambda: synthetic.corner_sphere(4),
    lambda: P.default_transfer_function(),
    lambda: P.Camera.initial(),
    lambda: P.reset_preset(),
    lambda: phong.default_light(),
    lambda: interop.light_from_numpy([0, 1, 0], [1, 1, 1], 0.3, 0.6, 0.2,
                                     8.0),
    lambda: texture.stub_blue(2, 2),
    lambda: conv3d.reference_kernel(),
    lambda: camera_recovery.angles_to_camera(0.1, 0.2, 0.3),
    lambda: server.RenderService.from_path("sphere"),
    lambda: server.serve("sphere", port=0),
])
def test_entry_points_need_cuda_without_a_device(no_cuda, entry):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


def test_render_without_device_needs_cuda(no_cuda):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.render(vol, P.default_transfer_function(device="cpu"),
                 P.reset_preset(device="cpu"), cfg)


@pytest.mark.parametrize("kw", [
    dict(lighting=True), dict(tf_lut=256, lighting=True),
    dict(lighting=True, algorithm=P.Algorithm.TEST)])
def test_lit_render_without_device_needs_cuda(no_cuda, kw):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4, **kw)
    for mode in ("fast", "scan"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.render(vol, P.default_transfer_function(device="cpu"),
                     P.reset_preset(device="cpu"), cfg, mode=mode)


def test_cli_without_device_needs_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["render", "--width", "8", "--height", "8", "--spr", "4",
                  "--out", os.path.join(tmp_path, "x.png")])


def test_cli_lit_render_without_device_needs_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["render", "--width", "8", "--height", "8", "--spr", "4",
                  "--lighting", "--gradient-filter", "sobel",
                  "--out", os.path.join(tmp_path, "x.png")])


def test_render_vrc_diff_without_device_needs_cuda(no_cuda):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        march_vjp.render_vrc_diff(vol, P.default_transfer_function(device="cpu"),
                                  P.reset_preset(device="cpu"), cfg)


@pytest.mark.parametrize("entry", [
    lambda vol, tf, cam, cfg: P.render(vol, tf, cam, cfg),
    lambda vol, tf, cam, cfg: smooth_vjp.render_vrc_smooth_diff(vol, tf, cam,
                                                                cfg),
    lambda vol, tf, cam, cfg: fit.fit_transfer_function(
        vol, cam, np.zeros((8, 8, 4), np.float32), tf, cfg, steps=1,
        fit_bounds=True),
])
def test_smooth_entry_points_without_device_need_cuda(no_cuda, entry):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4,
                         interp=P.Interp.TRILINEAR)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(vol, P.default_transfer_function(device="cpu"),
              P.reset_preset(device="cpu"), cfg)


def test_cli_smooth_without_device_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit", "--width", "8", "--height", "8", "--spr", "4",
                  "--steps", "1", "--interp", "trilinear", "--fit-bounds"])


@pytest.mark.parametrize("entry", [
    lambda vol, tf, cam, cfg: P.render(vol, tf, cam, cfg),
    lambda vol, tf, cam, cfg: a5_vjp.render_test_diff(vol, tf, cam, cfg),
    lambda vol, tf, cam, cfg: fit.fit_transfer_function(
        vol, cam, np.zeros((8, 8, 4), np.float32), tf, cfg, steps=1),
])
def test_a5_entry_points_without_device_need_cuda(no_cuda, entry):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4,
                         algorithm=P.Algorithm.TEST)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(vol, P.default_transfer_function(device="cpu"),
              P.reset_preset(device="cpu"), cfg)


@pytest.mark.parametrize("entry", [
    lambda vol, tf, cam, cfg: P.render(vol, tf, cam, cfg),
    lambda vol, tf, cam, cfg: P.render(
        vol, tf, cam, cfg.replace(algorithm=P.Algorithm.TEST)),
    lambda vol, tf, cam, cfg: march_vjp.render_vrc_scatter_diff(vol, tf, cam,
                                                                cfg),
    lambda vol, tf, cam, cfg: fit.fit_transfer_function(
        vol, cam, np.zeros((8, 8, 4), np.float32), tf, cfg, steps=1),
])
def test_scatter_entry_points_without_device_need_cuda(no_cuda, entry):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4,
                         scattering=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(vol, P.default_transfer_function(device="cpu"),
              P.reset_preset(device="cpu"), cfg)


def test_cli_scattering_without_device_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["render", "--width", "8", "--height", "8", "--spr", "4",
                  "--scattering"])


def test_fit_without_device_needs_cuda(no_cuda):
    vol = synthetic.centered_sphere(8, device="cpu")
    cfg = P.RenderConfig(width=8, height=8, samples_per_ray=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit.fit_transfer_function(
            vol, P.reset_preset(device="cpu"), np.zeros((8, 8, 4), np.float32),
            P.default_transfer_function(device="cpu"), cfg, steps=1)


def test_cli_fit_without_device_needs_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit", "--width", "8", "--height", "8", "--spr", "4",
                  "--steps", "1"])


@pytest.mark.parametrize("camera", ["preset", "0.9,0.5,1.0"])
def test_cli_render_writes_the_rendered_png(tmp_path, camera):
    out = os.path.join(tmp_path, "sphere.png")
    argv = ["render", "--data", "sphere", "--width", "30", "--height", "22",
            "--spr", "40", "--camera", camera, "--device", "cpu", "--out", out]
    assert cli.main(argv) == 0
    cfg = P.RenderConfig(width=30, height=22, samples_per_ray=40)
    cam = cli._camera(cli.build_parser().parse_args(argv), cfg, "cpu")
    img = P.render(synthetic.centered_sphere(device="cpu"),
                   P.default_transfer_function(device="cpu"), cam, cfg,
                   device="cpu")
    want = imageio.to_uint8(imageio.to_display(img))[..., :3]
    got = np.asarray(Image.open(out).convert("RGB"))
    assert got.shape == (22, 30, 3)
    np.testing.assert_array_equal(got, want)


def test_cli_tf_file(tmp_path):
    tf_path = os.path.join(tmp_path, "tf.txt")
    with open(tf_path, "w") as f:
        f.write("empty 0 1\nbone 30 80\n")
    out = os.path.join(tmp_path, "bone.png")
    assert cli.main(["render", "--width", "12", "--height", "12", "--spr",
                     "16", "--tf", tf_path, "--device", "cpu",
                     "--out", out]) == 0
    assert Image.open(out).size == (12, 12)


def test_png_encoder_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    path = os.path.join(tmp_path, "x.png")
    with open(path, "wb") as f:
        f.write(imageio.encode_png(rgb))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), rgb)
