#!/usr/bin/env python3
"""Side-by-side times of the a1 march kernels (K1, K4) in several checkouts.

    python3 volumerenderingproject_tpu_torch/harness/ab_march.py OLD NEW

Each argument is the root of a checkout of this repository (a directory
holding ``volumerenderingproject_tpu_torch/``), for example the parent
commit unpacked with ``git archive`` beside the working tree.  The trees
run in the order OLD NEW NEW OLD (for more trees: forward, then backward),
each in a process of its own that builds its kernels from its own
``csrc/`` into its own ``build/kernels/``, so a change of the kernel
sources is compared within one machine and one call.  Needs one CUDA GPU.

Each process times, on chip_smoke.py's inputs (an 8-frame orbit at
700x700, 500 samples per ray, eps 1e-3, on ``centered_sphere(100)`` and on
the seeded 182x218x182 volume), K1 per frame; on the latter, K4 at the fit
path's ortho orbit; and where the tree has them, K1's LUT variant at
``lut_300`` and its baked variant at ``sobel_lit_700``.  Times are
chip_smoke.py's: CUDA events behind a GPU spin, each window's ms per call.
It prints one JSON line per process and, last, each tree's windows pooled
over its runs and their median.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

WINDOWS = 5  # timed windows per measurement and process


def _smoke(repo_root: str):
    """chip_smoke.py of the checkout holding this script, as a module (its
    helpers only; its main does not run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(repo_root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed_windows(S, fn, reps: int) -> list:
    """ms per call of ``fn`` in each of WINDOWS windows: CUDA events around
    ``reps`` calls queued behind a GPU spin (chip_smoke.timed_ms, every
    window kept)."""
    import gc

    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    gc.disable()
    try:
        for _ in range(WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(S.PREFILL_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / reps)
    finally:
        gc.enable()
    return out


def measure(tree: str) -> dict:
    """Windows (ms per frame or call) of every kernel the tree has."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    S = _smoke(here)
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np

    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.ingest import synthetic
    from volumerenderingproject_tpu_torch.ops import march, march_vjp

    def per_frame(cfg, vol, seed=0):
        """Windows of K1 over an 8-frame orbit, in ms per frame."""
        xs = [march.prepare(vol, tf, cam, cfg, 1e-3) for cam in
              S.orbit_cameras(P, np.random.default_rng(seed))]

        def orbit():
            for x in xs:
                march.march_kernel(x)

        return [w / S.FRAMES for w in timed_windows(S, orbit, 5)]

    out = {}
    tf = P.default_transfer_function()
    volumes = {
        "sphere100": synthetic.centered_sphere(100),
        "mni_dims": P.make_volume(S.mni_like_volume(0)),
    }
    cfg = P.RenderConfig(width=S.W, height=S.H, samples_per_ray=S.SPR,
                         early_termination=1e-3)
    for vname, vol in volumes.items():
        out[f"k1_plain/{vname}"] = per_frame(cfg, vol)
    vol = volumes["mni_dims"]
    cam = S.orbit_cameras(P, np.random.default_rng(3), 1)[0]
    a, _ = march_vjp.prepare_diff(vol, tf, cam, P.RenderConfig(
        width=S.W, height=S.H, samples_per_ray=S.SPR))
    g = S.cotangents(a, np.random.default_rng(2))
    out["k4/mni_dims"] = timed_windows(
        S, lambda: march_vjp.march_bwd_kernel(a, *g), 5)
    if hasattr(march, "variant"):  # trees with the LUT and baked variants
        for cname, var in (("lut_300", "lut"), ("sobel_lit_700", "baked")):
            c = P.RenderConfig(**S.LIT_CONFIGS[cname]).replace(
                early_termination=1e-3)
            out[f"k1_{var}/{cname}/mni_dims"] = per_frame(c, vol)
    return out


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps({"tree": argv[1], "ms": measure(argv[1])}),
              flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    order = list(argv) + list(reversed(argv))
    pooled = {t: {} for t in argv}
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"FAIL: {tree} exited {proc.returncode}", flush=True)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        for name, ws in json.loads(line)["ms"].items():
            pooled[tree].setdefault(name, []).extend(ws)
    summary = {t: {n: {"median": sorted(ws)[len(ws) // 2], "n": len(ws)}
                   for n, ws in d.items()} for t, d in pooled.items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
