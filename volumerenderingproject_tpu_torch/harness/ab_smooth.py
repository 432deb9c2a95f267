#!/usr/bin/env python3
"""Side-by-side times of the smooth-mode kernels (K8, K9) of this checkout
and of other trees.

    python3 volumerenderingproject_tpu_torch/harness/ab_smooth.py TREE...

Each TREE is a directory holding ``volumerenderingproject_tpu_torch/csrc/``
with the smooth sources: the root of another checkout (the parent commit
unpacked with ``git archive``), or a copy of this tree's ``csrc/`` with one
thing changed, such as the kernels' block shape.  Each tree's
``smooth.cu`` and ``smooth_bwd.cu`` are built from its own sources into
``build/trees/<name>/``; all run in this one process, launched through
their C functions alike (chip_smoke.smooth_runs), and are timed in turns:
this tree, then each TREE, then back in reverse.  Needs one CUDA GPU.

The inputs are chip_smoke.py's: on ``centered_sphere(100)`` and the seeded
182x218x182 volume, K8 over an 8-frame orbit at 700x700, 500 samples per
ray, eps 1e-3, and K9 without and with the volume gradient at an orbit
camera at eps 0.  Times are chip_smoke.py's (CUDA events behind a GPU
spin, median of 3 windows, each of 5 calls), a tree's two turns averaged.
It prints the card, one line per kernel and volume, and last a JSON
object {volume: {tree: {kernel: ms}}}, K8's per frame.  Each tree's K8 is
checked bit-exact to this tree's first.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _smoke():
    """chip_smoke.py of this checkout, as a module (its helpers only)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv) -> int:
    if not argv or any(a.startswith("-") for a in argv):
        print(__doc__)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.ingest import synthetic
    from volumerenderingproject_tpu_torch.ops import _build, smooth, smooth_vjp

    S = _smoke()
    if not torch.cuda.is_available():
        print("FAIL: this script needs a CUDA GPU")
        return 2
    print(S.nvidia_smi_line(), flush=True)
    names = [os.path.basename(os.path.abspath(t)) for t in argv]
    if "this tree" in names or len(set(names)) != len(names):
        print(f"FAIL: the trees need distinct names, got {names}")
        return 2
    builds = {n: S.start_tree_build(_build, t) for n, t in zip(names, argv)}
    _build.build(list(S.TREE_SMOOTH))
    libs = {"this tree": {n: _build.load(n) for n in S.TREE_SMOOTH}}
    libs.update({n: S.tree_libs(b) for n, b in builds.items()})

    tf = P.default_transfer_function()
    cfg = P.RenderConfig(width=S.W, height=S.H, samples_per_ray=S.SPR,
                         interp=P.Interp.TRILINEAR)
    main_cfg = cfg.replace(early_termination=1e-3)
    out = {}
    for vname, vol in (("sphere100", synthetic.centered_sphere(100)),
                       ("mni_dims_182x218x182",
                        P.make_volume(S.mni_like_volume(0)))):
        cams = S.orbit_cameras(P, np.random.default_rng(17))
        args8 = [smooth.prepare_smooth(vol, tf, c, main_cfg, 1e-3)
                 for c in cams]
        a9 = smooth_vjp.prepare_smooth_diff(
            vol, tf, S.orbit_cameras(P, np.random.default_rng(14), 1)[0], cfg)
        g = S.cotangents(a9, np.random.default_rng(13))
        runs = {t: S.smooth_runs(smooth, smooth_vjp, lib, args8, a9, g)
                for t, lib in libs.items()}
        want = smooth.march_smooth_kernel(args8[0])
        try:  # each tree's K8 through the wrapper, its library in place
            for tree, lib in libs.items():
                _build._loaded["smooth"] = lib["smooth"]
                got = smooth.march_smooth_kernel(args8[0])
                S.check(torch.equal(got, want),
                        f"{vname}: {tree}'s K8 differs from this tree's")
        finally:
            _build._loaded["smooth"] = libs["this tree"]["smooth"]
        means = S.time_in_turns(runs, vname)
        for tree in means:
            means[tree][f"K8 x{S.FRAMES}"] /= S.FRAMES
        out[vname] = means
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
