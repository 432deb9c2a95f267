"""The rank workers of the sharded-render and sharded-fit checks
(``chip_smoke.py`` phases 4h and 7m, ``tests/test_torch_parallel_spawn.py``),
run through ``volumerenderingproject_tpu_torch.parallel.launch.spawn``.

It imports the PyTorch port and nothing of JAX: a spawned rank imports this
module by name (its directory is on the parent's ``sys.path``), never the
test module that calls it.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from volumerenderingproject_tpu_torch.diff import fit
from volumerenderingproject_tpu_torch.ops import a5, a5_vjp, march, march_vjp
from volumerenderingproject_tpu_torch.parallel.launch import rank_device
from volumerenderingproject_tpu_torch.parallel.mesh import make_mesh
from volumerenderingproject_tpu_torch.parallel.render_dist import (
    render_vrc_sharded)


def reset_launches() -> None:
    """Set the launch counts of K1, K3, K4 and K6, in all, by variant and by
    work unit, to 0."""
    march.launches = a5.launches = a5.segment_launches = 0
    march_vjp.launches = a5_vjp.launches = a5_vjp.segment_launches = 0
    for counts in (march.variant_launches, march.shard_launches,
                   a5.variant_launches, march_vjp.variant_launches,
                   march_vjp.shard_launches):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    return {"k1": dict(march.variant_launches),
            "k1_shard": dict(march.shard_launches),
            "k3": dict(a5.variant_launches),
            "k3_segment": a5.segment_launches,
            "k4": dict(march_vjp.variant_launches),
            "k4_shard": dict(march_vjp.shard_launches),
            "k6_segment": a5_vjp.segment_launches}


def render_jobs(rank: int, world_size: int, jobs, out_dir: str,
                backend: str, device=None) -> None:
    """Render each job on this rank and write, per job and rank,
    ``{name}.rank{r}.npy`` (the [W, H, 4] image every rank holds) and
    ``{name}.rank{r}.json`` (the mesh coordinates, the launches of K1 and K3
    by variant and by work unit, and the host ms per frame).

    A job is a dict: ``name``, ``mesh`` (rays, samples, volume), the CPU
    ``volume``, ``tf``, ``camera`` and ``config``, and optionally ``frames``
    (the renders timed and counted; 1 by default, and with more one untimed
    render goes first) and ``mode`` (``render_vrc_sharded``'s, "fast" by
    default).  Each mesh shape is built once: every rank builds the same
    shapes in the same order.
    """
    dev = rank_device(rank, backend, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    meshes = {}
    for job in jobs:
        shape = tuple(job["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        vol, tf, cam = (job[k].to(dev) for k in ("volume", "tf", "camera"))
        frames = int(job.get("frames", 1))

        def render():
            return render_vrc_sharded(vol, tf, cam, job["config"], mesh,
                                      mode=job.get("mode", "fast"))

        if frames > 1:
            render()  # warm-up
        dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        for _ in range(frames):
            img = render()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / frames
        counts = launch_counts()
        base = os.path.join(out_dir, f"{job['name']}.rank{rank}")
        np.save(base + ".npy", img.cpu().numpy())
        with open(base + ".json", "w") as f:
            json.dump({"coords": list(mesh.coords), "ms_per_frame": ms,
                       "frames": frames, "device": str(dev), **counts}, f)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_jobs(rank: int, world_size: int, jobs, out_dir: str, backend: str,
             device=None) -> None:
    """Fit each job on this rank through ``diff/fit.fit_transfer_function``
    with the job's mesh, and write, per job and rank,
    ``{name}.rank{r}.npz`` (the parameters after the fit, in
    ``FitParams.parameters()`` order, ``p0``, ``p1``, ..., and the losses)
    and ``{name}.rank{r}.json`` (the mesh coordinates).

    A job is a dict: ``name``, ``mesh``, the CPU ``volume``, ``tf``,
    ``camera``, ``config`` and ``target`` [W, H, 4], ``steps`` and ``lr``,
    optionally ``light`` (an ``ops.phong.Light``, whose parameters are
    fitted too), ``mode`` (the fit's route, "fast" by default) and
    ``timed_steps``.  With ``timed_steps`` the rank then
    takes, from the same start, one step through ``make_train_step`` whose
    gradients (summed over the mesh) go into the npz as ``g0``, ``g1``, ...,
    and ``timed_steps`` more, timed by the host clock around them
    (synchronised), with the launches of K1, K3, K4 and K6 set to 0 just
    before and read just after: ``ms_per_step`` and the launches per step
    go into the json.
    """
    dev = rank_device(rank, backend, device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    meshes = {}
    for job in jobs:
        shape = tuple(job["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(*shape)
        mesh = meshes[shape]
        vol, tf, cam = (job[k].to(dev) for k in ("volume", "tf", "camera"))
        target = job["target"].to(dev)
        cfg = job["config"]
        light = job.get("light")
        light = None if light is None else light.to(dev)
        mode = job.get("mode", "fast")
        params, losses = fit.fit_transfer_function(
            vol, cam, target, tf, cfg, steps=job["steps"],
            learning_rate=job["lr"], mesh=mesh, light=light, device=dev,
            mode=mode)
        out = {f"p{i}": p.detach().cpu().numpy()
               for i, p in enumerate(params.parameters())}
        out["losses"] = np.asarray(losses, np.float64)
        meta = {"coords": list(mesh.coords), "device": str(dev)}
        timed = int(job.get("timed_steps", 0))
        if timed:
            params = fit.FitParams.init(tf, light=light)
            step = fit.make_train_step(tf, cfg, fit.make_optimizer(
                params, job["lr"]), mesh, mode)
            step(params, vol, cam, target)
            out.update({f"g{i}": p.grad.detach().cpu().numpy()
                        for i, p in enumerate(params.parameters())})
            dist.barrier()
            _sync(dev)
            reset_launches()
            t0 = time.perf_counter()
            for _ in range(timed):
                step(params, vol, cam, target)
            _sync(dev)
            meta["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed
            meta["steps"] = timed
            meta.update(launch_counts())
        base = os.path.join(out_dir, f"{job['name']}.rank{rank}")
        np.savez(base + ".npz", **out)
        with open(base + ".json", "w") as f:
            json.dump(meta, f)
