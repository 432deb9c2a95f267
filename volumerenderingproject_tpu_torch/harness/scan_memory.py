"""Peak device memory and time of a scan-route fit step by chunk length.

    python -m volumerenderingproject_tpu_torch.harness.scan_memory [CHUNK ...]

Runs on the GPU (it refuses the CPU).  For each chunk length (8, 16, 32
and 64 samples by default, ``models/raycast.SCAN_CHUNK`` set to it), it
takes one warm-up step and 2 timed steps of ``fit_transfer_function(
mode="scan")`` on a seeded MNI-dims-shaped volume (182x218x182) for two
configs: a lit a5 colour fit at 500x500 pixels and 500 samples a ray (the
scan with the most saved tensors a ray-sample) and a conic lit colour and
light fit at 700x700x500.  It prints one JSON line a (config, chunk): the
ms a step (CUDA events) and the peak MiB allocated above the start
(``torch.cuda.max_memory_allocated``), then the card's name and power
limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch


def _volume(P):
    """Nested ellipsoid shells plus seeded noise at 182x218x182, so every
    interval of the default transfer function occurs."""
    rng = np.random.default_rng(0)
    dims = (182, 218, 182)
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in dims]
    r = np.sqrt(axes[0][:, None, None] ** 2 / 0.8
                + axes[1][None, :, None] ** 2
                + axes[2][None, None, :] ** 2 / 0.9)
    data = 40.0 + 100.0 * np.sqrt(np.clip(1.0 - r, 0.0, None))
    data = np.where(r < 1.0, data, 0.0)
    data = data + rng.normal(0.0, 6.0, dims)
    return P.make_volume(data.astype(np.float32))


def _case(P, phong, name):
    tf = P.default_transfer_function()
    colors = tf.colors.clone()
    colors[1:, :3] += 0.15
    start = P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)
    if name == "lit_a5_500":
        cfg = P.RenderConfig(width=500, height=500, samples_per_ray=500,
                             algorithm=P.Algorithm.TEST, lighting=True)
        return cfg, P.Camera.initial(position=(0.9, 0.6, 1.1)), tf, start, None
    cfg = P.RenderConfig(width=700, height=700, samples_per_ray=500,
                         lighting=True, conic=True)
    light = phong.default_light()
    dev = light.color.device
    light = dataclasses.replace(light, ambient=torch.tensor(0.7, device=dev),
                                diffuse=torch.tensor(0.2, device=dev))
    return cfg, P.Camera.initial(position=(0.9, 0.5, 1.0)), tf, start, light


def main(argv) -> int:
    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.diff import fit
    from volumerenderingproject_tpu_torch.models import raycast
    from volumerenderingproject_tpu_torch.ops import phong

    if not torch.cuda.is_available():
        print("scan_memory needs a CUDA GPU", file=sys.stderr)
        return 2
    chunks = [int(a) for a in argv] or [8, 16, 32, 64]
    vol = _volume(P)
    for name in ("lit_a5_500", "conic_lit_light_700"):
        cfg, cam, tf, start, light = _case(P, phong, name)
        target = P.render(vol, tf, cam, cfg, mode="scan",
                          light=None if light is None else phong.default_light())
        for chunk in chunks:
            raycast.SCAN_CHUNK = chunk

            def run(steps):
                return fit.fit_transfer_function(
                    vol, cam, target, start, cfg, steps=steps,
                    learning_rate=1e-2, light=light, mode="scan")

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run(1)
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            _, losses = run(2)
            t1.record()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(json.dumps({"config": name, "chunk": chunk,
                              "ms_per_step": t0.elapsed_time(t1) / 2,
                              "peak_mib_above_start": peak,
                              "losses": losses}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or smi.stderr.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
