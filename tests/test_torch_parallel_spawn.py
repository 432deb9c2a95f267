"""Sharded renders and fits as they run: ranks in processes of their own
(``parallel/launch.spawn``), joined by gloo on the CPU, each holding its
work unit and the gathers, against the JAX package's ``render_vrc_sharded``
(its XLA scan segments, ``use_pallas=False``) on the JAX package's scene
(tests/test_parallel.py:15-25; seed 7, early termination 0); sharded fit
steps (``fit_transfer_function(mesh=...)``) against the port's
single-device fit; and the CLI's ``render --mesh``.  Every rank must return
the whole image, and end a fit with the same parameters."""

import json
import os

import numpy as np
import pytest
import torch

import volumerenderingproject_tpu as J
from volumerenderingproject_tpu.parallel import render_dist as jrd
from volumerenderingproject_tpu.parallel.mesh import make_mesh as jmake_mesh

from volumerenderingproject_tpu_torch import interop
from volumerenderingproject_tpu_torch.diff import fit as pfit
from volumerenderingproject_tpu_torch.harness import cli
from volumerenderingproject_tpu_torch.ops.phong import default_light
from volumerenderingproject_tpu_torch.parallel import launch
from volumerenderingproject_tpu_torch.utils import imageio
from volumerenderingproject_tpu_torch.utils.config import RenderConfig

import _torch_shard_worker as shard_worker

CAM_FIELDS = ("position", "front", "right", "up", "top_left")
TOL = 1e-5  # folds regroup the (C, T) sums
SCENE_CFG = J.RenderConfig(width=16, height=6, samples_per_ray=24)


def _scene(algorithm=J.Algorithm.VRC):
    rng = np.random.default_rng(7)
    jv = J.make_volume(rng.uniform(0.0, 255.0, size=(8, 10, 9))
                       .astype(np.float32))
    jtf = J.default_transfer_function()
    jc = J.Camera.initial(position=(0.4, 0.3, 0.9))
    jcfg = SCENE_CFG.replace(algorithm=algorithm)
    pv = interop.volume_from_numpy(np.asarray(jv.data), np.asarray(jv.cal_max),
                                   jv.dims, device="cpu")
    ptf = interop.transfer_function_from_numpy(
        *(np.asarray(getattr(jtf, k)) for k in ("lower", "upper", "colors",
                                                "hg_g")), device="cpu")
    pc = interop.camera_from_numpy(
        *(np.asarray(getattr(jc, k)) for k in CAM_FIELDS), device="cpu")
    return (jv, jtf, jc, jcfg), dict(volume=pv, tf=ptf, camera=pc,
                                     config=RenderConfig.from_json(
                                         jcfg.to_json()))


def _run(jobs, world, tmp_path):
    launch.spawn(shard_worker.render_jobs, world, "gloo", jobs,
                 str(tmp_path), "gloo", "cpu")
    out = {}
    for job in jobs:
        imgs, meta = [], []
        for r in range(world):
            base = os.path.join(tmp_path, f"{job['name']}.rank{r}")
            imgs.append(np.load(base + ".npy"))
            with open(base + ".json") as f:
                meta.append(json.load(f))
        out[job["name"]] = imgs, meta
    return out


def _check(imgs, meta, want, mesh):
    coords = sorted(tuple(m["coords"]) for m in meta)
    assert coords == sorted(
        (r, s, v) for r in range(mesh[0]) for s in range(mesh[1])
        for v in range(mesh[2]))
    for img, m in zip(imgs, meta):
        assert img.shape == (16, 6, 4) and m["device"] == "cpu"
        # on the CPU the plain versions run: no kernel launch
        assert sum(m["k1"].values()) == sum(m["k3"].values()) == 0
        np.testing.assert_array_equal(img, imgs[0])
    np.testing.assert_allclose(imgs[0], want, rtol=0, atol=TOL)


def test_gloo_ranks_match_jax_sharded(tmp_path):
    """4 ranks: a1 on (2, 2, 1) and (1, 2, 2), a5 on (2, 2, 1)."""
    jobs, wants = [], {}
    for name, mesh, alg in (("a1_rays_samples", (2, 2, 1), J.Algorithm.VRC),
                            ("a1_samples_volume", (1, 2, 2),
                             J.Algorithm.VRC),
                            ("a5_rays_samples", (2, 2, 1), J.Algorithm.TEST)):
        (jv, jtf, jc, jcfg), scene = _scene(alg)
        wants[name] = np.asarray(jrd.render_vrc_sharded(
            jv, jtf, jc, jcfg, jmake_mesh(*mesh), use_pallas=False))
        jobs.append(dict(name=name, mesh=mesh, **scene))
    got = _run(jobs, 4, tmp_path)
    for job in jobs:
        _check(*got[job["name"]], wants[job["name"]], job["mesh"])


def test_gloo_full_mesh_8_ranks(tmp_path):
    (jv, jtf, jc, jcfg), scene = _scene()
    want = np.asarray(jrd.render_vrc_sharded(
        jv, jtf, jc, jcfg, jmake_mesh(2, 2, 2), use_pallas=False))
    got = _run([dict(name="full", mesh=(2, 2, 2), **scene)], 8, tmp_path)
    _check(*got["full"], want, (2, 2, 2))


def test_gloo_fit_steps_match_single_device(tmp_path):
    """4 ranks take 2 fit_transfer_function steps on (2, 2, 1) and (1, 2,
    2), and a lit colour and light fit on (2, 2, 1): every rank ends with
    the same parameters, bit for bit, within 1e-5 of the single-device
    fit's 2 steps."""
    _, scene = _scene()
    target = torch.from_numpy(np.random.default_rng(8).uniform(
        0.0, 1.0, (16, 6, 4)).astype(np.float32))
    jobs = [dict(name=f"fit_{m[0]}{m[1]}{m[2]}", mesh=m, target=target,
                 steps=2, lr=1e-2, **scene) for m in ((2, 2, 1), (1, 2, 2))]
    jobs.append(dict(jobs[0], name="fit_light_221",
                     config=scene["config"].replace(lighting=True),
                     light=default_light("cpu")))
    launch.spawn(shard_worker.fit_jobs, 4, "gloo", jobs, str(tmp_path),
                 "gloo", "cpu")
    for job in jobs:
        want, losses = pfit.fit_transfer_function(
            scene["volume"], scene["camera"], target, scene["tf"],
            job["config"], steps=2, learning_rate=1e-2,
            light=job.get("light"), device="cpu")
        want = [p.detach().numpy() for p in want.parameters()]
        got = [np.load(os.path.join(tmp_path, f"{job['name']}.rank{r}.npz"))
               for r in range(4)]
        for r in range(4):
            for i, w in enumerate(want):
                np.testing.assert_array_equal(got[r][f"p{i}"], got[0][f"p{i}"])
        for i, w in enumerate(want):
            np.testing.assert_allclose(got[0][f"p{i}"], w, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)


def test_a_failing_rank_fails_the_run(tmp_path):
    """Smooth mode has no segment kernel: every rank raises, and so does
    the spawn."""
    _, scene = _scene()
    scene["config"] = scene["config"].replace(
        interp=type(scene["config"].interp).TRILINEAR)
    with pytest.raises(Exception, match="mode='scan'"):
        _run([dict(name="smooth", mesh=(2, 1, 1), **scene)], 2, tmp_path)


def test_cli_mesh_render_matches_unsharded(tmp_path):
    args = ["render", "--device", "cpu", "--width", "32", "--height", "24",
            "--spr", "40", "--camera", "0.9,0.4,1.1"]
    whole, sharded = tmp_path / "whole.png", tmp_path / "sharded.png"
    assert cli.main(args + ["--out", str(whole)]) == 0
    assert cli.main(args + ["--out", str(sharded), "--mesh",
                            "rays=2,samples=2", "--backend", "gloo"]) == 0
    a, b = (np.round(imageio.load_png(str(p)) * 255.0).astype(np.int32)
            for p in (whole, sharded))
    assert a.shape == b.shape == (24, 32, 3)
    # (C, T) regrouped by the fold: at most one level of 8 bits apart
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 0.01


def test_cli_mesh_refuses_nccl_without_gpus():
    with pytest.raises((RuntimeError, ValueError), match="nccl"):
        cli.main(["render", "--device", "cpu", "--mesh", "rays=2",
                  "--backend", "nccl"])
    with pytest.raises(ValueError, match="--mesh"):
        cli.parse_mesh("rays=2,pixels=3", "gloo")
    assert cli.parse_mesh("samples=2,volume=2", "gloo") == dict(
        rays=1, samples=2, volume=2)
