"""Port parity of camera recovery (``harness/camera_recovery.py``) and the
CLI's ``recover-golden``: the Fibonacci directions and the golden's grey
image exactly, the orbit camera within 2e-7 of the JAX package's (float32
``sin``/``cos`` may differ from XLA's by an ulp) and within 1e-6 of every
committed record of ``goldens/recovered_cameras.json``, and whole
recoveries on a seeded asymmetric volume against the JAX package's."""

import json
import math
import os
import struct

import numpy as np
import pytest
import torch

from volumerenderingproject_tpu.harness import camera_recovery as jrec
from volumerenderingproject_tpu.ingest.volume import make_volume as jmake
from volumerenderingproject_tpu.scene.transfer_function import (
    default_transfer_function as jdefault_tf)
from volumerenderingproject_tpu.utils.config import Algorithm as JAlgorithm

import volumerenderingproject_tpu_torch as P
from volumerenderingproject_tpu_torch.harness import camera_recovery as rec
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.utils import imageio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "goldens")
FIELDS = ("position", "front", "right", "up", "top_left")
TOL_CAMERA = 2e-7  # against the JAX package's orbit camera
TOL_RECORD = 1e-6  # against the committed records
TOL_NCC = 1e-5
LEAD = 1e-4  # a best coarse score this far ahead of the next fixes the angles
TRUTH = (1.1, 2.3, 0.4)  # the targets' camera


def asymmetric_volume(seed: int = 0) -> np.ndarray:
    """[16, 16, 16]: nested ellipsoid shells of the default TF's intervals,
    an off-centre block and seeded noise, so that no rotation maps it onto
    itself."""
    rng = np.random.default_rng(seed)
    ax = np.arange(16, dtype=np.float32) - 7.5
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt((x / 7) ** 2 + (y / 6) ** 2 + (z / 5) ** 2)
    vol = np.full((16, 16, 16), 10.0, np.float32)
    vol[r < 1.0] = 55.0
    vol[r < 0.6] = 112.0
    vol[2:6, 9:14, 3:7] = 150.0
    return vol + rng.normal(0.0, 4.0, vol.shape).astype(np.float32)


def write_nifti(path: str, data: np.ndarray) -> None:
    """A NIfTI-1 float32 file of [X, Y, Z] ``data`` in the reader's order
    (``load_nifti`` gives it back), cal_max 255."""
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, 16)
    struct.pack_into("<h", hdr, 72, 32)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 124, 255.0)
    with open(path, "wb") as f:
        f.write(bytes(hdr) + b"\x00" * 4)
        f.write(np.ascontiguousarray(data, np.float32).tobytes())


@pytest.mark.parametrize("n", [1, 7, 24, 200, 1500])
def test_fibonacci_directions_equal(n):
    assert np.array_equal(rec.fibonacci_directions(n),
                          jrec.fibonacci_directions(n))


def test_angles_to_camera_matches_jax():
    rng = np.random.default_rng(3)
    angles = np.stack([rng.uniform(0, math.pi, 64),
                       rng.uniform(0, 2 * math.pi, 64),
                       rng.uniform(-math.pi, 2 * math.pi, 64)],
                      -1).astype(np.float32)
    angles[:4, 0] = [0.0, math.pi / 2, 1e-4, math.pi - 1e-4]
    batch = rec.angles_to_camera(*torch.as_tensor(angles).T)
    worst = 0.0
    for i, a in enumerate(angles):
        want = jrec.angles_to_camera(*a)
        got = rec.angles_to_camera(*a, device="cpu")
        for k in FIELDS:
            w = np.asarray(getattr(want, k))
            worst = max(worst, float(np.abs(getattr(got, k).numpy() - w).max()))
            assert np.array_equal(getattr(batch, k)[i].numpy(),
                                  getattr(got, k).numpy())
    print(f"angles_to_camera vs JAX: {worst:.3e}")
    assert worst <= TOL_CAMERA


def test_recovered_records_rebuild():
    with open(os.path.join(GOLDENS, "recovered_cameras.json")) as f:
        records = json.load(f)
    assert records
    for name, r in records.items():
        cam = rec.angles_to_camera(*np.float32(r["angles"]), device="cpu")
        for k in FIELDS:
            err = np.abs(getattr(cam, k).numpy() - np.asarray(r["camera"][k]))
            assert err.max() <= TOL_RECORD, (name, k, err.max())


@pytest.mark.parametrize("png", ["avg152_100x100_a1_spr100.png",
                                 "avg152_100x100_a5_spr100.png",
                                 "sphere_100x100_a1_spr100.png"])
@pytest.mark.parametrize("res", [100, 50, 33])
def test_golden_gray_equal(png, res):
    path = os.path.join(GOLDENS, png)
    for alg, jalg in ((P.Algorithm.VRC, JAlgorithm.VRC),
                      (P.Algorithm.TEST, JAlgorithm.TEST)):
        got = rec._golden_gray(path, alg, (res, res))
        want = jrec._golden_gray(path, jalg, (res, res))
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.fixture(scope="module")
def scene():
    vol = asymmetric_volume()
    return (P.make_volume(vol, device="cpu"),
            P.default_transfer_function("cpu"), jmake(vol), jdefault_tf(),
            vol)


def _target(tmp_path, scene, alg_id, size=16):
    """A golden-named PNG of the scene from the TRUTH camera."""
    vol, tf = scene[:2]
    alg = rec.ALGO_BY_ID[alg_id]
    cfg = P.RenderConfig(width=size, height=size, samples_per_ray=16,
                         algorithm=alg)
    img = P.render(vol, tf, rec.angles_to_camera(*TRUTH, device="cpu"), cfg,
                   device="cpu")
    path = str(tmp_path / f"image_{size}x{size}_a{alg_id}_spr16.png")
    imageio.save_png(path, img, alg)
    return path


@pytest.mark.parametrize("alg_id", [1, 5])
def test_recover_camera_matches_jax(tmp_path, scene, alg_id):
    vol, tf, jvol, jtf, _ = scene
    path = _target(tmp_path, scene, alg_id)
    kw = dict(n_dirs=24, n_rolls=4, search_res=16, refine_rounds=1,
              verbose=False)
    want = jrec.recover_camera(path, jvol, jtf, **kw)
    got = rec.recover_camera(path, vol, tf, device="cpu", **kw)
    assert set(got) == set(want)
    for k in ("ncc_search", "ncc_refined"):
        assert abs(got[k] - want[k]) <= TOL_NCC, (k, got[k], want[k])
    assert got["refine_res"] == want["refine_res"] == 16
    assert got["view_angle"] == want["view_angle"]
    # the coarse scores' lead of the best over the next decides whether the
    # angles must agree
    cfg = P.RenderConfig(width=16, height=16, samples_per_ray=16,
                         algorithm=rec.ALGO_BY_ID[alg_id],
                         early_termination=1e-3)
    score = rec._make_score_fn(vol, tf, cfg, rec._golden_gray(
        path, cfg.algorithm, (16, 16)))
    dirs = rec.fibonacci_directions(24)
    rolls = np.linspace(0.0, 2 * math.pi, 4, endpoint=False,
                        dtype=np.float32)
    scores = sorted(
        (float(score(rec.angles_to_camera(d[0], d[1], r, device="cpu")))
         for d in dirs for r in rolls), reverse=True)
    assert abs(scores[0] - got["ncc_search"]) <= 1e-7
    lead = scores[0] - scores[1]
    print(f"a{alg_id}: NCC {got['ncc_search']:.6f} -> {got['ncc_refined']:.6f}"
          f" (JAX {want['ncc_search']:.6f} -> {want['ncc_refined']:.6f}), "
          f"coarse lead {lead:.2e}, angles {got['angles']}")
    if lead > LEAD:
        assert got["angles"] == want["angles"]
    if got["angles"] == want["angles"]:
        for k in FIELDS:
            assert np.abs(np.asarray(got["camera"][k])
                          - np.asarray(want["camera"][k])).max() <= TOL_CAMERA


def test_cli_recover_golden(tmp_path, scene, capsys):
    nii = str(tmp_path / "vol.nii")
    write_nifti(nii, scene[4])
    goldens = tmp_path / "captures"
    goldens.mkdir()
    # the search renders at 100x100, the golden's least size
    paths = [_target(goldens, scene, a, 100) for a in (1, 5)]
    out = str(tmp_path / "out" / "cams.json")
    assert cli.main(["recover-golden", "--golden-dir", str(goldens),
                     "--dataset", nii, "--out", out, "--n-dirs", "4",
                     "--n-rolls", "2", "--device", "cpu"]) == 0
    with open(out) as f:
        got = json.load(f)
    assert sorted(got) == sorted(os.path.basename(p) for p in paths)
    for name, r in got.items():
        assert set(r) == {"golden", "angles", "ncc_search", "ncc_refined",
                          "refine_res", "view_angle", "camera"}
        assert r["golden"] == name and len(r["angles"]) == 3
        assert -1.0 <= r["ncc_search"] <= r["ncc_refined"] <= 1.0
        cam = rec.angles_to_camera(*np.float32(r["angles"]), device="cpu")
        for k in FIELDS:
            assert getattr(cam, k).tolist() == r["camera"][k]
    assert "-> NCC" in capsys.readouterr().out
