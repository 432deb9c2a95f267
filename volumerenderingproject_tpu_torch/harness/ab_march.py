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

Each process times K1, ms per launch, in every variant and unit mode, on
chip_smoke.py's inputs, each on ``centered_sphere(100)`` and on the seeded
182x218x182 volume (MNI-dims; for mc, bench.py's 3-channel 91^3 and the
seeded 3-channel MNI-dims volume), over an 8-frame orbit at eps 1e-3:
plain (700x700, 500 samples per ray), LUT (``lut_300``), baked
(``sobel_lit_700``), LUT + baked (``lut_phong_300``), lit and lut_lit
(conic 700x700x500, the latter at ``tf_lut=256``), mc
(``multichannel_304``); the units of one orbit camera at eps 1e-3, per
unit: segment (the (2, 2, 1) mesh of 700x700x500), slab (the (2, 2, 2)
mesh) and baked slab (the (1, 2, 2) mesh at ``sobel_lit_700``, eps 0, the
forward of a lit slab's fit unit); and bench.py's dense sphere at 320^3 and
512^3 (304x304x300, 4 frames), plain and baked.  Then K4 on MNI-dims at
the fit path's ortho orbit (eps 0): plain, with TF(0).alpha 0.05 (a fit's
steps after the first, where every sample off the volume has alpha), LUT
(``tf_lut=256``), baked (``sobel_lit_700``), and per unit over the segment
units of a (2, 2, 1) mesh and the slab units of a (1, 2, 2) one.  A tree's
K4 blocks are its own (its wrapper sizes the partials).  Times are
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

    def per_call(xs):
        """Windows of K1 over the march inputs ``xs``, in ms per launch."""
        def run():
            for x in xs:
                march.march_kernel(x)

        return [w / len(xs) for w in timed_windows(S, run, 5)]

    def per_frame(cfg, vol, frames=S.FRAMES, seed=0):
        """Windows of K1 over an orbit of ``frames`` frames at eps 1e-3."""
        cfg = cfg.replace(early_termination=1e-3)
        return per_call([march.prepare(vol, tf, cam, cfg, 1e-3) for cam in
                         S.orbit_cameras(P, np.random.default_rng(seed),
                                         frames)])

    def per_unit(cfg, vol, shape, diff=False):
        """Windows of K1 over the units of a ``shape`` mesh under one orbit
        camera, in ms per unit: at eps 1e-3, or at eps 0 as a fit's forward
        (``diff``)."""
        cam = S.orbit_cameras(P, np.random.default_rng(4), 1)[0]
        kws = [S.unit_kwargs(vol, cfg, shape, xyz)
               for xyz in S.mesh_coords(shape)]
        if diff:
            xs = [march_vjp.prepare_diff(vol, tf, cam, cfg, **kw)[0]
                  for kw in kws]
        else:
            cfg = cfg.replace(early_termination=1e-3)
            xs = [march.prepare(vol, tf, cam, cfg, 1e-3, **kw) for kw in kws]
        return per_call(xs)

    out = {}
    tf = P.default_transfer_function()
    volumes = {
        "sphere100": synthetic.centered_sphere(100),
        "mni_dims": P.make_volume(S.mni_like_volume(0)),
    }
    mc_vols = S.mc_volumes(P)
    cfg = P.RenderConfig(width=S.W, height=S.H, samples_per_ray=S.SPR)
    lit = P.RenderConfig(**S.LIT_CONFIGS["sobel_lit_700"])
    k1 = {"plain": cfg,
          "lut/lut_300": P.RenderConfig(**S.LIT_CONFIGS["lut_300"]),
          "baked/sobel_lit_700": lit,
          "lut_baked/lut_phong_300": P.RenderConfig(
              **S.LIT_CONFIGS["lut_phong_300"]),
          "lit/conic": P.RenderConfig(**S.CONIC_LIT),
          "lut_lit/conic": P.RenderConfig(**S.CONIC_LIT, tf_lut=256)}
    for vname, vol in volumes.items():
        for name, c in k1.items():
            out[f"k1_{name}/{vname}"] = per_frame(c, vol)
        out[f"k1_segment/(2, 2, 1)/{vname}"] = per_unit(cfg, vol, (2, 2, 1))
        out[f"k1_slab/(2, 2, 2)/{vname}"] = per_unit(cfg, vol, (2, 2, 2))
        out[f"k1_baked_slab/(1, 2, 2)/{vname}"] = per_unit(
            lit, vol, (1, 2, 2), diff=True)
    for vname, vol in zip(("bench3_91", "mni3"), mc_vols.values()):
        out[f"k1_mc/multichannel_304/{vname}"] = per_frame(
            P.RenderConfig(**S.MC_SHAPE), vol)
    del mc_vols
    for n in S.LARGE_SIZES:
        dense = S.dense_volume(P, n)
        for row in ("streamed", "streamed_lit"):
            out[f"k1_{row}/dense_{n}"] = per_frame(
                S.large_config(P, row), dense, frames=4)
        del dense
    vol = volumes["mni_dims"]
    cam = S.orbit_cameras(P, np.random.default_rng(3), 1)[0]
    fit_cfg = P.RenderConfig(width=S.W, height=S.H, samples_per_ray=S.SPR)

    def k4(name, tfx, cfg, shape=None):
        """Windows of K4 at ``cfg`` (per unit over a mesh of ``shape``)."""
        kws = [{}] if shape is None else [
            S.unit_kwargs(vol, cfg, shape, xyz) for xyz in
            S.mesh_coords(shape)]
        units = []
        for kw in kws:
            a, _ = march_vjp.prepare_diff(vol, tfx, cam, cfg, **kw)
            units.append((a, S.cotangents(a, np.random.default_rng(2))))

        def run():
            for a, g in units:
                march_vjp.march_bwd_kernel(a, *g)

        out[name] = [w / len(units) for w in timed_windows(S, run, 5)]

    k4("k4/mni_dims", tf, fit_cfg)
    k4("k4_alpha0_0.05/mni_dims", S.tf_with_alpha(P, tf, 0, 0.05), fit_cfg)
    k4("k4_lut/mni_dims", tf, fit_cfg.replace(tf_lut=256))
    k4("k4_baked/sobel_lit_700/mni_dims", tf, lit)
    k4("k4_segment/(2, 2, 1)/mni_dims", tf, fit_cfg, (2, 2, 1))
    k4("k4_slab/(1, 2, 2)/mni_dims", tf, fit_cfg, (1, 2, 2))
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
