"""Port parity, the CLI's remaining commands and what they stand on: the
native NIfTI loader (``load_nifti(backend=...)``) on NIfTI-1 and NIfTI-2
files, little- and big-endian, 3-D and 4-D, written here; ``ingest/vvi``,
``synthetic.octant_sphere_colors`` and ``harness/goldens`` against the
JAX package's; ``harness/profiling``; and the subcommands ``orbit``,
``bench``, ``info`` and ``compare`` and ``render``'s ``--orbit``,
``--depth``, ``--exact-points`` and ``--algorithm point``, each writing
what the renderers return, on the CPU at small sizes."""

import json
import os

import numpy as np
import pytest
import torch

from volumerenderingproject_tpu.harness import goldens as jgoldens
from volumerenderingproject_tpu.ingest import load_nifti as jload_nifti
from volumerenderingproject_tpu.ingest import synthetic as jsynthetic
from volumerenderingproject_tpu.ingest import vvi as jvvi

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch import native
from volumerenderingproject_tpu_torch.harness import cli, goldens, profiling
from volumerenderingproject_tpu_torch.ingest import synthetic, vvi
from volumerenderingproject_tpu_torch.models import point_splat
from volumerenderingproject_tpu_torch.utils import imageio

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "goldens")
SIZE = ["--width", "20", "--height", "14", "--spr", "24"]


def _write_nifti(path, data, version, order, dtype, cal_max=0.0,
                 slope=0.0, inter=0.0):
    """A NIfTI-1 (348-byte header) or NIfTI-2 (540) file of ``data``
    [X, Y, Z] or [X, Y, Z, C] in the byte order ``order``, the voxels
    x-fastest as the format stores them."""
    codes = {np.uint8: 2, np.int16: 4, np.int32: 8, np.float32: 16,
             np.float64: 64, np.uint16: 512, np.int64: 1024}
    dt = np.dtype(dtype).newbyteorder(order)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    payload = np.ascontiguousarray(
        np.moveaxis(data, -1, 0) if data.ndim == 4 else data).astype(dt)
    if version == 1:
        hdr = bytearray(352)
        put = lambda off, fmt, vals: hdr.__setitem__(  # noqa: E731
            slice(off, off + np.dtype(fmt).itemsize * len(vals)),
            np.asarray(vals, np.dtype(fmt).newbyteorder(order)).tobytes())
        put(0, np.int32, [348])
        put(40, np.int16, dims)
        put(70, np.int16, [codes[dtype]])
        put(72, np.int16, [dt.itemsize * 8])
        put(76, np.float32, [1.0, 1.5, 2.0, 0.5, 1, 1, 1, 1])
        put(108, np.float32, [352.0])
        put(112, np.float32, [slope, inter])
        put(124, np.float32, [cal_max, 0.0])
        hdr[344:348] = b"n+1\x00"
    else:
        hdr = bytearray(544)
        put = lambda off, fmt, vals: hdr.__setitem__(  # noqa: E731
            slice(off, off + np.dtype(fmt).itemsize * len(vals)),
            np.asarray(vals, np.dtype(fmt).newbyteorder(order)).tobytes())
        put(0, np.int32, [540])
        hdr[4:12] = b"n+2\x00\r\n\x1a\n"
        put(12, np.int16, [codes[dtype], dt.itemsize * 8])
        put(16, np.int64, dims)
        put(104, np.float64, [1.0, 1.5, 2.0, 0.5, 1, 1, 1, 1])
        put(168, np.int64, [544])
        put(176, np.float64, [slope, inter, cal_max, 0.0])
    with open(path, "wb") as f:
        f.write(bytes(hdr) + payload.tobytes())


NIFTIS = [(version, order, shape, dtype)
          for version in (1, 2) for order in ("<", ">")
          for shape, dtype in (((6, 5, 4), np.int16), ((5, 4, 3, 3),
                                                       np.float32))]


@pytest.mark.parametrize("version,order,shape,dtype", NIFTIS)
def test_native_loader_matches_python_and_jax(tmp_path, version, order,
                                              shape, dtype):
    rng = np.random.default_rng(version * 10 + len(shape))
    data = rng.uniform(-50.0, 300.0, shape).astype(dtype)
    path = os.path.join(tmp_path, "v.nii")
    _write_nifti(path, data, version, order, dtype, slope=2.0, inter=1.0)
    for scaling in (False, True):
        want = jload_nifti(path, apply_scaling=scaling, backend="python")
        vols = [P.load_nifti(path, backend=b, apply_scaling=scaling,
                             device="cpu") for b in ("native", "python",
                                                     "auto")]
        for v in vols:
            np.testing.assert_array_equal(v.data.numpy(),
                                          np.asarray(want.data))
            assert v.dims == want.dims and v.channels == want.channels
            for k in ("cal_max", "cal_min", "pixdim"):
                np.testing.assert_array_equal(getattr(v, k).numpy(),
                                              np.asarray(getattr(want, k)))
    hdr = native.nifti_header(path)
    assert hdr["sizeof_hdr"] == (348 if version == 1 else 540)
    assert hdr["swapped"] == (order == ">")


def test_auto_loader_takes_python_where_native_refuses(tmp_path):
    """int64 voxels: the native reader refuses them (a ValueError), so
    ``auto`` reads them with numpy and ``native`` raises."""
    data = np.arange(24, dtype=np.int64).reshape(2, 3, 4)
    path = os.path.join(tmp_path, "i64.nii")
    _write_nifti(path, data, 1, "<", np.int64, cal_max=30.0)
    got = P.load_nifti(path, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), data.astype(np.float32))
    with pytest.raises(ValueError, match="native nifti"):
        P.load_nifti(path, backend="native", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        P.load_nifti(path, backend="gpu", device="cpu")


VVI = ('<vtkKWOpenFileProperties Version="$Revision: 1.20 $" '
       'Spacing="0.5 0.75 2" Origin="-1 0 3.5" ScalarType="10" '
       'WholeExtent="0 181 0 217 0 181" NumberOfScalarComponents="1" '
       'IndependentComponents="1" FileOrientation="0 1 2" '
       'BigEndianFlag="0" FileDimensionality="3"/>')


def test_vvi_octants_and_goldens_match_jax(tmp_path):
    path = os.path.join(tmp_path, "v.nii.vvi")
    with open(path, "w") as f:
        f.write(VVI)
    ours, theirs = vvi.load_vvi(path), jvvi.load_vvi(path)
    for field in ("version", "spacing", "origin", "scalar_type",
                  "whole_extent", "num_scalar_components",
                  "independent_components", "file_orientation", "big_endian",
                  "file_dimensionality", "dims", "dtype_name"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert P.ingest.parse_vvi(VVI) == vvi.parse_vvi(VVI)
    with pytest.raises(ValueError):
        vvi.parse_vvi("<nothing/>")
    for dims in ((10, 10, 10), (9, 12, 7)):
        np.testing.assert_array_equal(
            synthetic.octant_sphere_colors(dims, (0.1, 0.3, 0.2)),
            jsynthetic.octant_sphere_colors(dims, (0.1, 0.3, 0.2)))
    rng = np.random.default_rng(4)
    a, b = rng.uniform(0, 1, (2, 12, 9, 3)).astype(np.float32)
    assert goldens.similarity(a, b) == jgoldens.similarity(a, b)
    assert goldens.similarity(a, a[:5]) == 0.0
    pal = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    assert goldens.palette_distance(a, pal) == jgoldens.palette_distance(a,
                                                                         pal)
    assert goldens.foreground_fraction(a) == jgoldens.foreground_fraction(a)
    names = sorted(os.listdir(GOLDEN_DIR)) + ["image_700x700_a1_spr500.png",
                                              "x.png"]
    for name in names:
        assert (goldens.parse_golden_name(name)
                == jgoldens.parse_golden_name(name))


def test_profiling_stage_timer_and_trace(tmp_path):
    timer = profiling.StageTimer()
    with timer.stage("one") as out:
        out["x"] = torch.ones(3) * 2
    timer.record("two", 0.5)
    assert list(timer.as_dict()) == ["one", "two"]
    assert "total" in timer.report().splitlines()[-1]
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def _png(path, w, h):
    img = imageio.load_png(path)
    assert img.shape == (h, w, 3)
    return img


def test_cli_point_renders(tmp_path):
    """``render --algorithm point`` (and with ``--orbit``), ``--depth`` of
    the point cloud and of the ray caster, ``--exact-points``: each PNG is
    what the renderer returns."""
    vol = synthetic.centered_sphere(device="cpu")
    tf = P.default_transfer_function(device="cpu")
    base = ["render", "--data", "sphere", *SIZE, "--device", "cpu"]
    cases = {
        "point": (["--algorithm", "point"], lambda cam, cfg:
                  point_splat.render_points(vol, tf, cam, cfg)),
        "point_orbit": (["--algorithm", "point", "--orbit", "30,-20,0.1"],
                        lambda cam, cfg:
                        point_splat.render_points(vol, tf, cam, cfg)),
        "point_depth": (["--algorithm", "point", "--depth"], lambda cam, cfg:
                        point_splat.render_points_depth(vol, cam, cfg)),
        "vrc_depth": (["--depth"], lambda cam, cfg:
                      point_splat.render_depth_vrc(vol, tf, cam, cfg)),
        "exact": (["--algorithm", "point", "--exact-points"], lambda cam, cfg:
                  point_splat.render_points(vol, tf, cam, cfg, exact=True)),
    }
    for name, (flags, fn) in cases.items():
        out = os.path.join(tmp_path, f"{name}.png")
        argv = base + flags + ["--out", out]
        assert cli.main(argv) == 0
        args = cli.build_parser().parse_args(argv)
        cfg = cli._config(args)
        img = fn(cli._camera(args, cfg, "cpu"), cfg)
        want = imageio.to_uint8(imageio.to_display(img, cfg.algorithm))
        np.testing.assert_array_equal(
            _png(out, 20, 14), want[..., :3].astype(np.float32) / 255.0)
    with pytest.raises(SystemExit, match="single-device path"):
        cli.main(base + ["--algorithm", "point", "--mesh", "rays=2",
                         "--backend", "gloo"])


def test_cli_orbit_bench_info_compare(tmp_path, capsys):
    prefix = os.path.join(tmp_path, "orbit_")
    assert cli.main(["orbit", "--data", "sphere", *SIZE, "--device", "cpu",
                     "--frames", "2", "--step-deg", "30",
                     "--out-prefix", prefix]) == 0
    frames = [_png(f"{prefix}{i:04d}.png", 20, 14) for i in range(2)]
    assert not np.array_equal(frames[0], frames[1])
    capsys.readouterr()
    assert cli.main(["bench", "--data", "sphere", *SIZE, "--device", "cpu",
                     "--repeats", "2", "--algorithm", "point",
                     "--profile", str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "rays_per_sec_20x14_spr24"
    assert line["unit"] == "rays/s" and line["value"] > 0
    assert "frame1" in out and os.path.exists(tmp_path / "prof" /
                                              "trace.json")
    nii = os.path.join(tmp_path, "h.nii")
    _write_nifti(nii, np.zeros((4, 5, 6), np.float32), 2, ">", np.float32,
                 cal_max=200.0)
    assert cli.main(["info", "--data", nii]) == 0
    out = capsys.readouterr().out
    assert "SIZEOF_HDR: 540" in out and "BYTEORDER: >" in out
    assert "CAL_MAX: 200.0" in out
    a, b = frames[0], os.path.join(tmp_path, "image_20x14_a1_spr24.png")
    imageio.save_png(b, np.transpose(1.0 - a, (1, 0, 2)))
    ours = f"{prefix}0000.png"
    assert cli.main(["compare", "--ours", ours, "--golden", ours,
                     "--threshold", "0.99"]) == 0
    assert cli.main(["compare", "--ours", ours, "--golden", b,
                     "--threshold", "0.5"]) == 1
    out = capsys.readouterr().out
    assert "golden config: {'width': 20" in out


def test_cli_prints_the_auto_route(tmp_path, capsys):
    """The default ``--mode auto`` prints its route: the scan for a conic
    scattered frame (no kernel computes it), the kernel otherwise."""
    out = os.path.join(tmp_path, "r.png")
    base = ["render", "--data", "sphere", *SIZE, "--device", "cpu",
            "--out", out]
    assert cli.main(base + ["--conic", "--scattering"]) == 0
    assert "route: render: mode='auto' takes the scan route" in (
        capsys.readouterr().out)
    assert cli.main(base) == 0
    assert "route: render: mode='auto' takes the kernel route" in (
        capsys.readouterr().out)
