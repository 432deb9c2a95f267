#!/usr/bin/env python3
"""Side-by-side times of the march kernels (the a1 marches K1 and K4, the
a5 marches K3 and K6) in several checkouts.

    python3 volumerenderingproject_tpu_torch/harness/ab_march.py [--only
        PREFIXES] OLD NEW

Each argument is the root of a checkout of this repository (a directory
holding ``volumerenderingproject_tpu_torch/``), for example the parent
commit unpacked with ``git archive`` beside the working tree.  The trees
run in the order OLD NEW NEW OLD (for more trees: forward, then backward),
each in a process of its own that builds its kernels from its own
``csrc/`` into its own ``build/kernels/``, so a change of the kernel
sources is compared within one machine and one call.  Needs one CUDA GPU.
``--only k3,k6`` times only the cases whose names start with one of the
comma-separated prefixes (here the a5 marches; the default is every case).

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
units of a (2, 2, 1) mesh and the slab units of a (1, 2, 2) one.  Then K3
on both volumes over an 8-frame orbit at eps 1e-3: unlit (``a5_500``,
500x500x500), baked (a5 lit 300^3), per unit over the (2, 2, 1) mesh of
``a5_500`` under one orbit camera; and ``streamed_a5`` on the dense sphere
at 320^3 and 512^3 (304x304x300, 4 frames).  Then K6 on both volumes at
``a5_500`` (eps 0, one orbit camera, as the a5 fit runs it): plain, with
TF(0).alpha 0.05, per unit over the (2, 2, 1) mesh; and the K7 fold on the
dense sphere at 320^3 and 512^3 (304x304x300).  A tree's K4 and K6 blocks
are its own (its wrappers size the partials).  Times are chip_smoke.py's:
CUDA events behind a GPU spin, each window's ms per call.  It prints one
JSON line per process and, last, each tree's windows pooled over its runs
and their median.
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


def measure(tree: str, only=None) -> dict:
    """Windows (ms per frame or call) of every kernel the tree has, or of
    the cases whose names start with one of the prefixes ``only``."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    S = _smoke(here)
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np

    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.ingest import synthetic
    from volumerenderingproject_tpu_torch.ops import (a5, a5_vjp, march,
                                                      march_vjp)

    def want(prefix):
        return only is None or any(p.startswith(prefix) or
                                   prefix.startswith(p) for p in only)

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
    cfg = P.RenderConfig(width=S.W, height=S.H, samples_per_ray=S.SPR)
    lit = P.RenderConfig(**S.LIT_CONFIGS["sobel_lit_700"])
    if want("k1"):
        k1_cases(out, S, P, volumes, cfg, lit, per_frame, per_unit)
    if want("k4"):
        k4_cases(out, S, P, march_vjp, tf, volumes, lit)
    if want("k3") or want("k6"):
        a5_cases(out, S, P, a5, a5_vjp, tf, volumes, want)
    return out


def k1_cases(out, S, P, volumes, cfg, lit, per_frame, per_unit) -> None:
    """K1's cases (the module's docstring) into ``out``."""
    mc_vols = S.mc_volumes(P)
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


def k4_cases(out, S, P, march_vjp, tf, volumes, lit) -> None:
    """K4's cases (the module's docstring) into ``out``."""
    import numpy as np

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


def a5_cases(out, S, P, a5, a5_vjp, tf, volumes, want) -> None:
    """K3's and K6's cases (the module's docstring) into ``out``."""
    import numpy as np

    test = P.Algorithm.TEST
    a5_cfg = P.RenderConfig(width=S.A5_W, height=S.A5_H,
                            samples_per_ray=S.A5_SPR, algorithm=test)
    a5_lit = P.RenderConfig(**S.A5_LIT, algorithm=test)

    def k3_windows(xs):
        def run():
            for x in xs:
                a5.march_a5_kernel(x)

        return [w / len(xs) for w in timed_windows(S, run, 5)]

    def k3_frames(c, vol, frames=S.FRAMES, seed=0):
        c = c.replace(early_termination=1e-3)
        return k3_windows([a5.prepare_a5(vol, tf, cam, c, 1e-3) for cam in
                           S.orbit_cameras(P, np.random.default_rng(seed),
                                           frames)])

    def k6_windows(units):
        def run():
            for a, g in units:
                a5_vjp.march_a5_bwd_kernel(a, *g)

        return [w / len(units) for w in timed_windows(S, run, 5)]

    def k6_units(vol, tfx, c, shape=None):
        cam = S.orbit_cameras(P, np.random.default_rng(7), 1)[0]
        kws = [{}] if shape is None else [
            S.unit_kwargs(vol, c, shape, xyz) for xyz in S.mesh_coords(shape)]
        units = []
        for kw in kws:
            a, _ = a5_vjp.prepare_a5_diff(vol, tfx, cam, c, **kw)
            units.append((a, S.cotangents(a, np.random.default_rng(2))))
        return k6_windows(units)

    tf05 = S.tf_with_alpha(P, tf, 0, 0.05)
    for vname, vol in volumes.items():
        if want("k3"):
            out[f"k3/a5_500/{vname}"] = k3_frames(a5_cfg, vol)
            out[f"k3_baked/a5_lit_300/{vname}"] = k3_frames(a5_lit, vol)
            cam = S.orbit_cameras(P, np.random.default_rng(4), 1)[0]
            c = a5_cfg.replace(early_termination=1e-3)
            out[f"k3_segment/(2, 2, 1)/{vname}"] = k3_windows([
                a5.prepare_a5(vol, tf, cam, c, 1e-3,
                              **S.unit_kwargs(vol, c, (2, 2, 1), xyz))
                for xyz in S.mesh_coords((2, 2, 1))])
        if want("k6"):
            out[f"k6/a5_500/{vname}"] = k6_units(vol, tf, a5_cfg)
            out[f"k6_alpha0_0.05/a5_500/{vname}"] = k6_units(vol, tf05,
                                                             a5_cfg)
            out[f"k6_segment/(2, 2, 1)/{vname}"] = k6_units(
                vol, tf, a5_cfg, (2, 2, 1))
    for n in S.LARGE_SIZES:
        dense = S.dense_volume(P, n)
        c = S.large_config(P, "streamed_a5")
        if want("k3"):
            out[f"k3_streamed_a5/dense_{n}"] = k3_frames(c, dense, frames=4)
        if want("k6"):
            out[f"k6_fold/dense_{n}"] = k6_units(dense, tf, c)
        del dense


def main(argv) -> int:
    only = []
    if len(argv) >= 2 and argv[0] == "--only":
        only = ["--only", argv[1]]
        argv = argv[2:]
    if len(argv) >= 2 and argv[0] == "--one":
        prefixes = only[1].split(",") if only else None
        print(json.dumps({"tree": argv[1], "ms": measure(argv[1], prefixes)}),
              flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    order = list(argv) + list(reversed(argv))
    pooled = {t: {} for t in argv}
    for tree in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__)]
                              + only + ["--one", tree], capture_output=True,
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
