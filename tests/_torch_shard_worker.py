"""The rank worker of the sharded-render checks (``chip_smoke.py`` phase 4h
and ``tests/test_torch_parallel_spawn.py``), run through
``volumerenderingproject_tpu_torch.parallel.launch.spawn``.

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

from volumerenderingproject_tpu_torch.ops import a5, march
from volumerenderingproject_tpu_torch.parallel.launch import rank_device
from volumerenderingproject_tpu_torch.parallel.mesh import make_mesh
from volumerenderingproject_tpu_torch.parallel.render_dist import (
    render_vrc_sharded)


def reset_launches() -> None:
    """Set K1's and K3's launch counts, in all, by variant and by work
    unit, to 0."""
    march.launches = a5.launches = a5.segment_launches = 0
    for counts in (march.variant_launches, march.shard_launches,
                   a5.variant_launches):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict:
    return {"k1": dict(march.variant_launches),
            "k1_shard": dict(march.shard_launches),
            "k3": dict(a5.variant_launches),
            "k3_segment": a5.segment_launches}


def render_jobs(rank: int, world_size: int, jobs, out_dir: str,
                backend: str, device=None) -> None:
    """Render each job on this rank and write, per job and rank,
    ``{name}.rank{r}.npy`` (the [W, H, 4] image every rank holds) and
    ``{name}.rank{r}.json`` (the mesh coordinates, the launches of K1 and K3
    by variant and by work unit, and the host ms per frame).

    A job is a dict: ``name``, ``mesh`` (rays, samples, volume), the CPU
    ``volume``, ``tf``, ``camera`` and ``config``, and optionally ``frames``
    (the renders timed and counted; 1 by default, and with more one untimed
    render goes first).  Each mesh shape is built once: every rank builds
    the same shapes in the same order.
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
            return render_vrc_sharded(vol, tf, cam, job["config"], mesh)

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
