#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``volumerenderingproject_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA GPU

Phases, each of which exits non-zero on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from ``csrc/`` (nvcc, in parallel);
  3. the forward march kernel (K1) against its plain PyTorch version on
     the card: on edge inputs at small shapes (TF(0).alpha = -3e-5
     among them), then at the main path's shapes (700x700 pixels, 500
     samples per ray) on two volumes: ``centered_sphere(100)`` and a
     seeded 182x218x182 volume (MNI152-1mm dims) of nested ellipsoid
     shells plus noise, so every interval of the default transfer
     function occurs;
  3b. the backward march kernel (K4) against its plain PyTorch version on
     the same edge inputs, on an interval of alpha exactly 1, on
     TF(0).alpha = -3e-5, on 16 intervals, on a static density_scale and
     at 700x700x500 on both volumes (ortho and conic), with one seeded
     cotangent per case; the error is max |dK4 - dplain| / max |dplain|;
  4. the render path: 8 orbit frames per volume through ``render()`` (the
     bench.py orbit, radius 1.5, early_termination=1e-3), with the kernels'
     launch counts set to 0 just before and read just after;
  5. the CLI: ``python -m volumerenderingproject_tpu_torch render ...``
     must write a valid 700x700 PNG;
  5b. the CLI: ``python -m volumerenderingproject_tpu_torch fit ...``
     against that PNG must write a TF file that parses;
  6. the kernel's render of a small input against the back-to-front
     reference scan;
  7. the fit path: on each volume, 5 ``fit_transfer_function`` steps at
     700x700x500 (lr 1e-2) from the default TF with its colours 1..3
     perturbed by a seeded +-0.2, against the render of the default TF from
     an orbit camera, with the launch counts of both kernels set to 0 just
     before and read just after; the same steps once more under
     torch.profiler for the device's busy time and idle share; 5 steps at
     lr 3e-6, where the loss must fall at every step; the gradient at the
     start against a central difference of the loss; then 2 steps through
     the kernels against the same 2 steps through their plain versions.

Kernel times are CUDA events around repeated launches queued behind a GPU
spin, the median of 3 windows.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on the main paths, its error against its plain version, its
time, the plain version's time and its bound; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
W = H = 700
SPR = 500
FRAMES = 8
TOL_EXACT = 2e-5  # kernel vs plain, eps = 0 (and at equal eps)
TOL_EPS = 1.1e-3  # kernel at eps = 1e-3 vs the exact plain render
TOL_GRAD = 5e-3  # backward kernel vs plain, relative to max |dplain|
TOL_FIT = 1e-5  # 2 fit steps, kernels vs plain versions
# central difference of the loss along its gradient (a step of FD_STEP in
# parameter units) against the change the gradient predicts: float32
# rounding of the two losses and the O(step^3) term stay well inside TOL_FD
FD_STEP = 1e-5
TOL_FD = 1e-2
FIT_STEPS = 5
FIT_LR = 1e-2
# at lr 1e-2 Adam moves TF(0).alpha by ~lr per step and the loss rises at
# 500 samples per ray (as in the JAX package); a step this small stays in
# the region where each update is a descent step
FIT_DESCENT_LR = 3e-6
CONIC_PIXEL_SHARE = 0.999  # conic: share of pixels within TOL_EXACT
# H100 SXM peaks (NVIDIA data sheet, at 700 W): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations one march sample costs: position 9, nearest-voxel index
# 18, time step 2, compositing 9 (csrc/march.cu)
FLOPS_PER_SAMPLE = 38
# float operations dL/dcolors needs per sample, each counted once however a
# kernel schedules it: position 9, nearest-voxel index 18, time step 2;
# w = T a 1, 1 - a 1, T (1 - a) 1; w (g . c) 1, its suffix sum 1, + T_N g_t
# 1, the division 1, T (g . c) 1, da 1, w g 3, the four terms added to their
# interval 4
FLOPS_PER_BWD_SAMPLE = 45
# and per ray: g . c_k for every interval (5 each) and T_N g_t (1)
FLOPS_PER_BWD_RAY_PER_INTERVAL = 5
FLOPS_PER_BWD_RAY = 1
# timed windows per measurement; the median is reported
TIMING_WINDOWS = 3
# GPU cycles spun before a kernel's timed window (~50 ms at 1.98 GHz), so
# the host has queued the launches before the first event
PREFILL_CYCLES = 100_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def mni_like_volume(seed: int = 0) -> np.ndarray:
    """[182, 218, 182] float32: nested ellipsoid shells whose intensities
    fall in the empty, bone, brain and muscle intervals of the default
    transfer function, plus seeded Gaussian noise that straddles the bounds."""
    rng = np.random.default_rng(seed)
    dims = (182, 218, 182)
    axes = [np.arange(d, dtype=np.float32) - (d - 1) / 2.0 for d in dims]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    r = np.sqrt((x / 80.0) ** 2 + (y / 100.0) ** 2 + (z / 78.0) ** 2)
    vol = np.full(dims, 10.0, np.float32)  # empty (alpha 0)
    vol[r < 1.0] = 55.0  # bone: [30, 80] / 255
    vol[r < 0.8] = 112.0  # brain: [105, 120] / 255
    vol[r < 0.45] = 150.0  # muscle: [140, 160] / 255
    vol += rng.normal(0.0, 6.0, dims).astype(np.float32)
    return vol


def timed_ms(fn, reps: int, prefill: bool = False,
             label: str | None = None) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls, the median
    of TIMING_WINDOWS such windows, with the garbage collector off.  With
    ``prefill`` (for kernels) the GPU spins first, so a host pause while the
    launches are queued does not show as device time; a plain version,
    whose time is its launches, is timed without it."""
    import gc

    import torch

    fn()
    torch.cuda.synchronize()
    windows = []
    gc.disable()
    try:
        for _ in range(TIMING_WINDOWS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if prefill:
                torch.cuda._sleep(PREFILL_CYCLES)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            windows.append(start.elapsed_time(end) / reps)
    finally:
        gc.enable()
    if label:
        log(f"{label}: windows {[round(w, 5) for w in windows]} ms")
    return sorted(windows)[len(windows) // 2]


def orbit_cameras(P, rng, frames: int = FRAMES, radius: float = 1.5):
    """bench.py:123-135: an orbit at radius 1.5 with a small seeded jitter."""
    thetas = (np.linspace(0.0, 2.0 * np.pi, frames + 1)[:frames]
              + rng.random(frames) * 1e-4)
    return [P.Camera.initial(position=(radius * np.cos(t),
                                       0.4 + 0.2 * np.sin(2.0 * t),
                                       radius * np.sin(t)))
            for t in thetas]


def check_png(path: str, width: int, height: int) -> None:
    """Signature, chunk CRCs, IHDR size and the decompressed scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    pos, idat, ihdr, tags = 8, [], None, []
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == crc,
              f"{path}: bad CRC in {tag!r}")
        tags.append(tag)
        if tag == b"IHDR":
            ihdr = body
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    check(ihdr is not None and tags[-1] == b"IEND", f"{path}: bad chunks")
    w, h = int.from_bytes(ihdr[0:4], "big"), int.from_bytes(ihdr[4:8], "big")
    check((w, h) == (width, height), f"{path}: size {w}x{h}")
    raw = zlib.decompress(b"".join(idat))
    check(len(raw) == h * (1 + 3 * w), f"{path}: {len(raw)} pixel bytes")


def tf16(P, device):
    """16 overlapping intervals with seeded bounds and colours (alphas up
    to 0.7, one of them 0)."""
    import torch

    rng = np.random.default_rng(16)
    lo = np.sort(rng.uniform(0.0, 0.9, 16)).astype(np.float32)
    hi = (lo + rng.uniform(0.02, 0.2, 16)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (16, 4)).astype(np.float32)
    colors[:, 3] *= np.float32(0.7)
    colors[5, 3] = 0.0
    return P.TransferFunction(*(torch.tensor(v, device=device) for v in (
        lo, hi, colors, np.zeros(16, np.float32))))


def tf_with_alpha(P, tf, k: int, alpha: float):
    """``tf`` with interval k's alpha set to ``alpha``."""
    colors = tf.colors.clone()
    colors[k, 3] = alpha
    return P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)


def cotangents(a, rng):
    """One seeded cotangent pair (g_rgb [W, H, 3], g_t [W, H]) on the card,
    N(0, 1) / (W * H): the scale of a mean-squared-error cotangent."""
    import torch

    scale = np.float32(1.0 / (a.width * a.height))
    g_rgb = rng.normal(0.0, 1.0, (a.width, a.height, 3)).astype(np.float32)
    g_t = rng.normal(0.0, 1.0, (a.width, a.height)).astype(np.float32)
    return (torch.tensor(g_rgb * scale, device=a.ids.device),
            torch.tensor(g_t * scale, device=a.ids.device))


def bwd_vs_plain(march_vjp, label, a, g):
    """Backward kernel and its plain version on the same inputs ->
    (max abs error, error relative to max |dplain|)."""
    import torch

    got = march_vjp.march_bwd_kernel(a, *g)
    want = march_vjp.march_bwd_plain(a, *g)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    e_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(scale > 0.0, f"{label}: the plain gradient is all zero")
    e_rel = e_abs / scale
    log(f"{label}: backward kernel vs plain max abs err {e_abs:.3e}, "
        f"relative {e_rel:.3e} (tol {TOL_GRAD:g}), max |dplain| {scale:.3e}")
    check(e_rel <= TOL_GRAD, f"{label}: relative error {e_rel}")
    return e_abs, e_rel


def fit_phase(P, fit, march, march_vjp, vname, vol, rng):
    """Phase 7 on one volume -> its numbers."""
    import torch

    tf = P.default_transfer_function()
    cam = orbit_cameras(P, rng, 1)[0]
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    target = P.render(vol, tf, cam, cfg)
    colors = tf.colors.clone()
    colors[1:, :3] += torch.tensor(
        rng.uniform(-0.2, 0.2, (3, 3)).astype(np.float32), device=colors.device)
    start_tf = P.TransferFunction(tf.lower, tf.upper, colors, tf.hg_g)

    def run(steps, lr=FIT_LR):
        return fit.fit_transfer_function(vol, cam, target, start_tf, cfg,
                                         steps=steps, learning_rate=lr)

    run(1)  # warm-up step
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    march.launches = march_vjp.launches = 0
    start.record()
    params, losses = run(FIT_STEPS)
    end.record()
    torch.cuda.synchronize()
    k1, k4 = march.launches, march_vjp.launches
    step_ms = start.elapsed_time(end) / FIT_STEPS
    log(f"{vname}: fit losses {losses}, {step_ms:.4f} ms/step, launches "
        f"K1 {k1} K4 {k4} for {FIT_STEPS} steps")
    check(k1 == k4 == FIT_STEPS, f"{vname}: launches K1 {k1} K4 {k4}")
    check(all(math.isfinite(v) for v in losses), f"{vname}: loss not finite")
    log(f"{vname}: at lr {FIT_LR:g} the loss after {FIT_STEPS} steps is "
        f"{losses[-1]:.6g} vs {losses[0]:.6g} at the start: "
        f"{'fell' if losses[-1] < losses[0] else 'did not fall'}")
    trace = profile_fit(lambda: run(FIT_STEPS))
    log(f"{vname}: the same {FIT_STEPS} steps under torch.profiler: "
        f"{trace['wall_ms'] / FIT_STEPS:.4f} ms/step, device busy "
        f"{trace['busy_ms'] / FIT_STEPS:.4f} ms/step (K1 "
        f"{trace['k1_ms'] / FIT_STEPS:.4f}, K4 {trace['k4_ms'] / FIT_STEPS:.4f}),"
        f" idle {trace['idle_share']:.4f} of the span from the first kernel to "
        f"the last ({trace['span_ms'] / FIT_STEPS:.4f} ms/step), "
        f"{trace['kernels']} device operations")

    # descent: the same start at a step small enough that every update
    # lowers the loss
    march.launches = march_vjp.launches = 0
    _, descent = run(FIT_STEPS, FIT_DESCENT_LR)
    d1, d4 = march.launches, march_vjp.launches
    log(f"{vname}: fit losses at lr {FIT_DESCENT_LR:g} {descent}, launches "
        f"K1 {d1} K4 {d4}")
    check(d1 == d4 == FIT_STEPS, f"{vname}: launches K1 {d1} K4 {d4}")
    check(all(b < a for a, b in zip(descent, descent[1:])),
          f"{vname}: the loss did not fall at every step at lr "
          f"{FIT_DESCENT_LR:g}")

    # the gradient at the start against a central difference of the loss
    # along it; the change it predicts is taken over the parameter steps as
    # float32 rounds them
    params = fit.FitParams.init(start_tf)
    fit.render_loss(params, start_tf, vol, cam, target, cfg).backward()
    grads = [params.tf_colors.grad, params.density_scale.grad]
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    check(math.isfinite(norm) and norm > 0.0, f"{vname}: gradient {norm}")
    with torch.no_grad():
        up, down = (fit.FitParams(*(p + (h / norm) * g for p, g in zip(
            params.parameters(), grads))) for h in (FD_STEP, -FD_STEP))
        l_up, l_down = (float(fit.render_loss(q, start_tf, vol, cam, target,
                                              cfg)) for q in (up, down))
        predicted = sum(float((g.double() * (u - d).double()).sum())
                        for g, u, d in zip(grads, up.parameters(),
                                           down.parameters()))
    fd_err = abs((l_up - l_down) - predicted) / abs(predicted)
    log(f"{vname}: |grad| {norm:.6g}; loss {l_down:.9g} a step of "
        f"{FD_STEP:g} down the gradient, {l_up:.9g} up it; the difference "
        f"{l_up - l_down:.6g} against {predicted:.6g} predicted by the "
        f"gradient (relative err {fd_err:.3e}, tol {TOL_FD:g})")
    check(fd_err <= TOL_FD and l_down < l_up,
          f"{vname}: gradient check failed")

    # the first 2 steps through the kernels and through the plain versions
    pk, lk = run(2)
    routes = march_vjp._forward, march_vjp._backward
    march_vjp._forward = march.march_plain
    march_vjp._backward = march_vjp.march_bwd_plain
    try:
        pp, lp = run(2)
    finally:
        march_vjp._forward, march_vjp._backward = routes
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    param_err = max(
        float((pk.tf_colors - pp.tf_colors).detach().abs().max()),
        float((pk.density_scale - pp.density_scale).detach().abs()))
    log(f"{vname}: 2 fit steps, kernels vs plain: losses {lk} vs {lp} "
        f"(max relative err {loss_err:.3e}), parameters max abs err "
        f"{param_err:.3e} (tol {TOL_FIT:g})")
    check(lk == losses[:2], f"{vname}: the fit is not deterministic")
    check(loss_err <= TOL_FIT and param_err <= TOL_FIT,
          f"{vname}: kernels vs plain fit steps differ")
    return dict(step_ms=step_ms, k1=k1, k4=k4, losses=losses, fd_err=fd_err,
                descent=descent, trace=trace)


def profile_fit(fn) -> dict:
    """Run ``fn`` under torch.profiler -> its wall time, the device time of
    K1, K4 and all device operations (their union), and the device's idle
    share of the span from the first device operation to the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type.name == "CUDA"
           and not getattr(e, "is_user_annotation", False)]
    check(len(ops) > 0, "the profiler recorded no device operation")
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy, lo = busy + (hi - lo), s
        hi = max(hi, e)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]

    def kernel_ms(name):
        return sum(e.time_range.end - e.time_range.start for e in ops
                   if name in e.name) / 1e3

    return dict(wall_ms=wall_ms, busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle_share=1.0 - busy / span, kernels=len(ops),
                k1_ms=kernel_ms("march_a1_kernel"),
                k4_ms=kernel_ms("march_bwd_a1_kernel"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA GPU")
        return 2
    sys.path.insert(0, ROOT)
    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.ingest import synthetic
    from volumerenderingproject_tpu_torch.diff import fit
    from volumerenderingproject_tpu_torch.ops import _build, march, march_vjp
    from volumerenderingproject_tpu_torch.scene.transfer_function import (
        from_text)

    # ---- 1. the card --------------------------------------------------------
    smi = nvidia_smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build -----------------------------------------------------------
    t0 = time.time()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build(sources)
    march._kernel_lib()
    march_vjp._kernel_lib()
    log(f"built {sources} in {time.time() - t0:.2f} s")

    # ---- 3. kernel vs plain on the card ------------------------------------
    tf = P.default_transfer_function()
    rng = np.random.default_rng(0)
    volumes = {
        "sphere100": synthetic.centered_sphere(100),
        "mni_dims_182x218x182": P.make_volume(mni_like_volume(0)),
    }
    cfg = P.RenderConfig(width=W, height=H, samples_per_ray=SPR)
    colors0 = tf.colors.clone()
    colors0[0, 3] = 0.05  # TF(0).alpha > 0: every skip turns off
    tf_alpha0 = P.TransferFunction(tf.lower, tf.upper, colors0, tf.hg_g)
    max_err = 0.0
    per_volume = {}

    def kernel_vs_plain(label, a, conic):
        """Kernel and plain version on the same inputs -> (kernel image,
        plain image, max abs error or None for conic rays)."""
        got = march.march_kernel(a)
        want = march.march_plain(a)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"{label}: not finite")
        err = (got - want).abs().amax(dim=-1)
        if conic:
            within = int((err <= TOL_EXACT).sum())
            log(f"{label}: {within}/{err.numel()} pixels within "
                f"{TOL_EXACT:g}, max err {float(err.max()):.3e}")
            check(within >= CONIC_PIXEL_SHARE * err.numel(),
                  f"{label}: only {within} pixels within tolerance")
            return got, want, None
        e = float(err.max())
        log(f"{label}: kernel vs plain max err {e:.3e} (tol {TOL_EXACT:g})")
        check(e <= TOL_EXACT, f"{label}: max err {e}")
        return got, want, e

    # edge inputs at small shapes: odd dims, truncated cal_max, front clip,
    # overlapping and single-interval tables, density_scale, a conic camera
    # inside the volume, skipping off, a ragged sample count
    edge_rng = np.random.default_rng(1)
    odd = P.make_volume(edge_rng.uniform(-30, 255, (13, 17, 20))
                        .astype(np.float32), cal_max=200.9)
    overlap = from_text("a 0.2 0.5 0.1 0.2 0.3 0.4\nb 0.4 0.7 0.5 0.6 0.7 0.8\n"
                        "c 0.45 0.46 0.9 0.8 0.7 0.6\nd 0.8 0.9 1 0 1 0.5 0.3\n")
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    # a fit's first Adam step can drive an alpha of 0 below 0
    tf_neg = tf_with_alpha(P, tf, 0, -3e-5)
    edge_cases = [
        ("front_clip", tf, near, small.replace(front_clip=0.5), 0.0),
        ("overlapping_tf_density", overlap, P.reset_preset(),
         small.replace(density_scale=0.45), 0.0),
        ("single_interval_tf", from_text("glass 0 1"), near, small, 0.0),
        ("conic_inside_volume", tf, P.Camera.initial(position=(0.1, 0.05, 0.2)),
         small.replace(conic=True), 0.0),
        ("no_skipping_eps1e-3", tf, P.reset_preset(),
         small.replace(empty_space_skipping=False), 1e-3),
    ]
    for name, tfx, cam, c, eps in edge_cases + [
            ("negative_alpha0_eps0", tf_neg, near, small, 0.0)]:
        kernel_vs_plain(f"edge/{name}", march.prepare(odd, tfx, cam, c, eps),
                        c.conic)
    for vname, vol in volumes.items():
        orbit_cam = orbit_cameras(P, rng, 1)[0]
        cases = [
            ("ortho_preset_eps0", tf, P.reset_preset(), cfg, 0.0),
            ("ortho_orbit_eps0", tf, orbit_cam, cfg, 0.0),
            ("ortho_orbit_eps1e-3", tf, orbit_cam, cfg, 1e-3),
            ("conic_eps0", tf, P.Camera.initial(position=(0.9, 0.5, 1.0)),
             cfg.replace(conic=True), 0.0),
            ("ortho_alpha0_eps0", tf_alpha0, orbit_cam, cfg, 0.0),
            ("ortho_negative_alpha0_eps0", tf_neg, orbit_cam, cfg, 0.0),
        ]
        exact = {}
        for name, tfx, cam, c, eps in cases:
            a = march.prepare(vol, tfx, cam, c, eps)
            got, want, e = kernel_vs_plain(f"{vname}/{name}", a, c.conic)
            if e is None:
                continue
            max_err = max(max_err, e)
            if eps == 0.0:
                exact[(id(tfx), id(cam))] = want
            else:
                ref = exact[(id(tfx), id(cam))]
                e2 = float((got - ref).abs().max())
                log(f"{vname}/{name}: kernel at eps {eps:g} vs exact plain "
                    f"max err {e2:.3e} (tol {TOL_EPS:g})")
                check(e2 <= TOL_EPS, f"{vname}/{name}: eps error {e2}")

        # kernel and plain times and the bound, at the main path's inputs
        cams = orbit_cameras(P, rng)
        eps = 1e-3
        args = [march.prepare(vol, tf, cam, cfg.replace(early_termination=eps),
                              eps) for cam in cams]

        def orbit_kernels():
            for a in args:
                march.march_kernel(a)

        kernel_ms = timed_ms(orbit_kernels, 5, prefill=True,
                             label=f"{vname}: march kernel x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: march.prepare(
            vol, tf, cams[0], cfg.replace(early_termination=eps), eps), 5)
        stats = {}
        march.march_plain(args[0], stats)
        plain_ms = timed_ms(lambda: march.march_plain(args[0]), 2)
        voxels = math.prod(vol.dims)
        nbytes = (voxels + args[0].occ.numel() * 4 + args[0].colors.numel() * 4
                  + W * H * 16)
        bound_ops_ms = stats["samples"] * FLOPS_PER_SAMPLE / PEAK_F32_FLOPS * 1e3
        bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        per_volume[vname] = dict(
            ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=max(bound_ops_ms, bound_bytes_ms),
            bound_by="operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
            samples=stats["samples"])
        log(f"{vname}: march kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms,"
            f" prep {prep_ms:.4f} ms, needed samples {stats['samples']}, "
            f"bound {bound_ops_ms:.4f} ms (operations) / {bound_bytes_ms:.4f} "
            f"ms (bytes)")

    # ---- 3b. the backward kernel vs plain on the card ------------------------
    grad_rng = np.random.default_rng(2)
    bwd_abs = bwd_rel = 0.0
    for name, tfx, cam, c, _ in edge_cases + [
            ("alpha_one", tf_with_alpha(P, tf, 3, 1.0), near, small, 0.0),
            ("negative_alpha0", tf_neg, near, small, 0.0),
            ("k16", tf16(P, tf.colors.device), near, small, 0.0),
            ("density_0.45", tf, near, small.replace(density_scale=0.45), 0.0)]:
        a, _ = march_vjp.prepare_diff(odd, tfx, cam, c)
        e_abs, e_rel = bwd_vs_plain(march_vjp, f"edge/{name}", a,
                                    cotangents(a, grad_rng))
        bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
    bwd_cam = orbit_cameras(P, np.random.default_rng(3), 1)[0]
    for vname, vol in volumes.items():
        for name, cam, c in (
                ("ortho_orbit", bwd_cam, cfg),
                ("conic", P.Camera.initial(position=(0.9, 0.5, 1.0)),
                 cfg.replace(conic=True))):
            a, _ = march_vjp.prepare_diff(vol, tf, cam, c)
            g = cotangents(a, grad_rng)
            e_abs, e_rel = bwd_vs_plain(march_vjp, f"{vname}/{name}", a, g)
            bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
            if c.conic:
                continue
            # times and the bound at the fit path's shapes
            bwd_ms = timed_ms(lambda: march_vjp.march_bwd_kernel(a, *g), 5,
                              prefill=True,
                              label=f"{vname}: backward kernel")
            bwd_plain_ms = timed_ms(lambda: march_vjp.march_bwd_plain(a, *g),
                                    1)
            fwd_eps0_ms = timed_ms(lambda: march.march_kernel(a), 5,
                                   prefill=True)
            k = a.colors.shape[0]
            samples = W * H * SPR  # every sample of every ray: no skip
            nbytes = (math.prod(vol.dims) + W * H * 16 + k * 16
                      + march_vjp.num_blocks(W, H) * k * 16)
            ops = (samples * FLOPS_PER_BWD_SAMPLE + W * H * (
                k * FLOPS_PER_BWD_RAY_PER_INTERVAL + FLOPS_PER_BWD_RAY))
            bound_ops_ms = ops / PEAK_F32_FLOPS * 1e3
            bound_bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            per_volume[vname].update(
                bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                fwd_eps0_ms=fwd_eps0_ms,
                bwd_bound_ms=max(bound_ops_ms, bound_bytes_ms),
                bwd_bound_by=("operations" if bound_ops_ms >= bound_bytes_ms
                              else "bytes"))
            log(f"{vname}: backward kernel {bwd_ms:.4f} ms, plain "
                f"{bwd_plain_ms:.2f} ms, forward kernel at eps 0 "
                f"{fwd_eps0_ms:.4f} ms, bound {bound_ops_ms:.4f} ms "
                f"(operations) / {bound_bytes_ms:.4f} ms (bytes)")

    # ---- 4. the render path -------------------------------------------------
    main_cfg = cfg.replace(early_termination=1e-3)
    frames = 0
    march.launches = 0
    for vname, vol in volumes.items():
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[-1], main_cfg)  # warm-up frame
        frames += 1
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, main_cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        frames += len(imgs)
        ms = start.elapsed_time(end) / len(imgs)
        for img in imgs:
            check(tuple(img.shape) == (W, H, 4), f"{vname}: shape {img.shape}")
            check(bool(torch.isfinite(img).all()), f"{vname}: not finite")
            fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                       .float().mean())
            check(fg > 0.01, f"{vname}: image is background only ({fg})")
        plain_frame_ms = timed_ms(
            lambda: march.march_plain(march.prepare(
                vol, tf, cams[0], main_cfg, 1e-3)), 1)
        per_volume[vname]["render_ms"] = ms
        log(f"{vname}: render() {ms:.4f} ms/frame, {W * H / ms * 1e3:.4e} "
            f"rays/s; plain march {plain_frame_ms:.2f} ms/frame")
    launches = march.launches
    log(f"march kernel launches on the main path: {launches} "
        f"for {frames} frames")
    check(launches == frames, f"launches {launches} != frames {frames}")

    # ---- 5. the CLI ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sphere.png")
        proc = subprocess.run(
            [sys.executable, "-m", "volumerenderingproject_tpu_torch",
             "render", "--data", "sphere", "--width", str(W), "--height",
             str(H), "--spr", str(SPR), "--out", out],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        log(f"cli exit {proc.returncode}: {proc.stdout.strip()} "
            f"{proc.stderr.strip()[-2000:]}")
        check(proc.returncode == 0, "cli render failed")
        check_png(out, W, H)

        # ---- 5b. the CLI fit against that PNG --------------------------------
        out_tf = os.path.join(tmp, "fitted.txt")
        proc = subprocess.run(
            [sys.executable, "-m", "volumerenderingproject_tpu_torch",
             "fit", "--data", "sphere", "--width", str(W), "--height",
             str(H), "--spr", str(SPR), "--target", out, "--steps", "3",
             "--out-tf", out_tf],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        log(f"cli fit exit {proc.returncode}: {proc.stdout.strip()} "
            f"{proc.stderr.strip()[-2000:]}")
        check(proc.returncode == 0, "cli fit failed")
        with open(out_tf) as f:
            fitted = from_text(f.read())
        check(fitted.num_intervals == tf.num_intervals
              and bool(torch.isfinite(fitted.colors).all()),
              "cli fit wrote a bad transfer function")

    # ---- 6. a small input against the reference scan ----------------------
    small = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    sphere = volumes["sphere100"]
    got = P.render(sphere, tf, P.reset_preset(), small)
    ref = P.render(sphere, tf, P.reset_preset(), small, mode="reference")
    e = float((got - ref).abs().max())
    log(f"sphere 100x100x100: kernel vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"kernel vs reference scan: {e}")

    # ---- 7. the fit path -----------------------------------------------------
    fit_rng = np.random.default_rng(4)
    fit_launches = {"k1": 0, "k4": 0}
    for vname, vol in volumes.items():
        r = fit_phase(P, fit, march, march_vjp, vname, vol, fit_rng)
        per_volume[vname]["fit_step_ms"] = r["step_ms"]
        per_volume[vname]["fit_idle_share"] = r["trace"]["idle_share"]
        fit_launches["k1"] += r["k1"]
        fit_launches["k4"] += r["k4"]
    log(f"march kernel launches on the fit path: {fit_launches['k1']}, "
        f"backward kernel launches: {fit_launches['k4']} "
        f"({FIT_STEPS} steps per volume)")

    main_vol = per_volume["mni_dims_182x218x182"]
    kernels = [{
        "name": "march_a1",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march.py:103",
        "launches": launches + fit_launches["k1"],
        "max_abs_err": max_err,
        "ms": main_vol["ms"],
        "plain_ms": main_vol["plain_ms"],
        "bound_ms": main_vol["bound_ms"],
        "bound_by": main_vol["bound_by"],
        "library_ms": None,
    }, {
        "name": "march_bwd_a1",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march_bwd.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march_vjp.py:88",
        "launches": fit_launches["k4"],
        "max_abs_err": bwd_abs,
        "ms": main_vol["bwd_ms"],
        "plain_ms": main_vol["bwd_plain_ms"],
        "bound_ms": main_vol["bwd_bound_ms"],
        "bound_by": main_vol["bwd_bound_by"],
        "library_ms": None,
    }]
    log(f"per volume: {json.dumps(per_volume)}")
    log(f"backward kernel max relative err over all cases {bwd_rel:.3e}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
