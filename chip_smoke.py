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

The a5 (Algorithm.TEST) slice, at bench.py's ``a5_500`` shapes (500x500
pixels, 500 samples per ray), has phases of its own, each with its own seeds:

  3c. the a5 march kernel (K3) against its plain version: on edge inputs
     (odd dims with negatives and cal_max 200.9, the z-wrap and y-wrap
     scenes, a z > 127 volume, TF(0).alpha 0.05 and -3e-5, a
     single-interval table, eps 1e-3), then on both volumes with an orbit
     camera at eps 0 and at eps 1e-3 (also against the exact render) and
     with the preset camera; its time on the render path's inputs, the
     samples they need and the bound;
  3d. the a5 backward kernel (K6) against its plain version on the same
     edges, an interval of alpha 1 and 16 intervals, and on both volumes;
  4b. 8 orbit frames per volume through ``render()`` with Algorithm.TEST
     (eps 1e-3), K3's launch count set to 0 just before and read just after;
  5c, 5d. the CLI ``render`` and ``fit`` with ``--algorithm test``;
  6b. a small a5 render against the a5 back-to-front reference scan;
  7b. phase 7 on the a5 route (K3 and K6).

The lit and LUT slice, at bench.py's ``sobel_lit_700`` (700x700 pixels, 250
samples per ray, ``lighting=True``, ``gradient_filter="sobel"``) and
``lut_phong_300`` (300x300x300, ``tf_lut=256``, ``lighting=True``) rows and
the a5 mode of the latter (300x300x300, ``Algorithm.TEST``,
``lighting=True``), has phases of its own, each with its own seeds:

  3e. K1's LUT, baked-light and LUT + baked-light variants against
     ``march_plain``, which must be bit-exact (max abs err 0) at eps 0: on
     edge inputs (tf_lut 2, 96, 256, 1024, a LUT grid point on an interval
     bound, TF(0).alpha -3e-5, rays that miss the box, sobel + presmooth,
     front clip with density_scale), then on both volumes at
     ``sobel_lit_700``, ``lut_phong_300`` and ``lut_phong_300`` unlit, at
     eps 0 and at eps 1e-3 (against the exact render); each variant's
     time, the bake's, the plain version's and the bound;
  3f. K3's baked-light variant against ``march_a5_plain`` on the a5 edge
     inputs, lit, and on both volumes at the a5 lit 300x300x300 config with
     central and sobel gradients;
  4c. 8 orbit frames per volume and config after one warm-up through
     ``render()``, with each variant's launch count set to 0 just before
     and read just after;
  5e. the CLI ``render --lighting --gradient-filter sobel`` and ``render
     --config <json with tf_lut 256> --lighting``, a1 and ``--algorithm
     test``, each of which must write a valid PNG;
  6c. a small lit a1 render and a small lit a5 render against their
     back-to-front reference scans.

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
# float operations dL/dcolors needs, each counted once however a kernel
# schedules it.  A sample inside the volume: position 9, nearest-voxel index
# 18, time step 2; the chain w = T a, 1 - a, T (1 - a), w (g . c), its suffix
# sum, + T_N g_t, the division, T (g . c), da 9; w and da into its
# interval's sums 2 (g multiplies an interval's sum of w once per ray)
FLOPS_PER_BWD_SAMPLE = 40
# a sample off the volume takes id0's colour, whose g . c is per ray: the
# chain 9 and its two sums 2 (whether it is off the volume follows from the
# ray's clip against the box, as in the forward bounds)
FLOPS_PER_BWD_OUTSIDE_SAMPLE = 11
# and per ray: for every interval g . c_k 5 and g times its sum of w 3;
# T_N g_t 1
FLOPS_PER_BWD_RAY_PER_INTERVAL = 8
FLOPS_PER_BWD_RAY = 1
# a5 (Algorithm.TEST): bench.py's a5_500 row, 500x500 pixels, 500 samples
A5_W = A5_H = A5_SPR = 500
# float operations one a5 sample needs, each counted once however a kernel
# schedules it (csrc/a5.cu): the three stage matrices 42 (the first stage's
# x and y terms once per ray), inside test 6, corner truncations and
# fractions 12, 1 - f 3, the y->x->z mix of 4 channels 84, compositing 9
FLOPS_PER_A5_SAMPLE = 156
FLOPS_PER_A5_RAY = 15  # first-stage x, y terms 9; C + T bg 6
# and what dL/dcolors needs per a5 sample inside the volume: position,
# inside, corners, fractions and 1 - f as above 63, the 8 trilinear weights
# from 4 pair products 12, each corner's weight into its interval's
# coefficient 8, the chain 9 (as a1's); then for each interval present (at
# most min(8, K)): a and g . rgb from its coefficient 4 (g . c_k is per ray)
# and coef w and coef da into its sums 4.  A sample off the volume costs
# FLOPS_PER_BWD_OUTSIDE_SAMPLE: its coefficients are [id0 == k].
FLOPS_PER_A5_BWD_SAMPLE = 92
FLOPS_PER_A5_BWD_SAMPLE_PER_INTERVAL = 8
# and per ray, besides the per-interval terms: T_N g_t 1 and the
# first-stage x, y terms 9
FLOPS_PER_A5_BWD_RAY = 10
# the lit slice: bench.py's sobel_lit_700 and lut_phong_300 rows and the a5
# mode of the latter; the baked variants add rgb * M + S, 6 operations, to
# every sample inside the volume
LIT_CONFIGS = {
    "sobel_lit_700": dict(width=700, height=700, samples_per_ray=250,
                          lighting=True, gradient_filter="sobel"),
    "lut_phong_300": dict(width=300, height=300, samples_per_ray=300,
                          tf_lut=256, lighting=True),
    "lut_300": dict(width=300, height=300, samples_per_ray=300, tf_lut=256),
}
A5_LIT = dict(width=300, height=300, samples_per_ray=300, lighting=True)
FLOPS_PER_BAKED_SAMPLE = 6
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


def fwd_vs_plain(kernel, plain, label, a, conic=False):
    """A forward kernel and its plain version on the same inputs -> (kernel
    image, plain image, max abs error or None for conic rays)."""
    import torch

    got = kernel(a)
    want = plain(a)
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


def bwd_vs_plain(kernel, plain, label, a, g):
    """A backward kernel and its plain version on the same inputs ->
    (max abs error, error relative to max |dplain|)."""
    import torch

    got = kernel(a, *g)
    want = plain(a, *g)
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


def samples_needed(plain, args) -> float:
    """Mean over ``args`` of the samples each march input needs (the plain
    version's ``stats["samples"]``: inside the volume, on live rays)."""
    total = 0
    for a in args:
        stats = {}
        plain(a, stats)
        total += stats["samples"]
    return total / len(args)


def bound(ops: float, nbytes: float):
    """-> (bound ms, what bounds it, operations ms, bytes ms): ``ops``
    float operations at the card's float32 peak against ``nbytes`` at its
    memory rate."""
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


class FitRoute:
    """One differentiable route of the fit: its forward kernel module and
    the backward module (each with a ``launches`` counter; the backward one
    holds the ``_forward``/``_backward`` that the autograd function calls),
    their plain versions, and the kernels' names in a profiler trace."""

    def __init__(self, label, fwd_mod, bwd_mod, plain_fwd, plain_bwd,
                 fwd_name, bwd_name):
        self.label, self.fwd_mod, self.bwd_mod = label, fwd_mod, bwd_mod
        self.plain = (plain_fwd, plain_bwd)
        self.names = (fwd_name, bwd_name)

    def reset(self):
        self.fwd_mod.launches = self.bwd_mod.launches = 0

    def counts(self):
        return self.fwd_mod.launches, self.bwd_mod.launches


def fit_phase(P, fit, route, vname, vol, rng, cfg):
    """Phase 7 (a1) or 7b (a5) on one volume -> its numbers."""
    import torch

    kf, kb = route.label
    tf = P.default_transfer_function()
    cam = orbit_cameras(P, rng, 1)[0]
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
    route.reset()
    start.record()
    params, losses = run(FIT_STEPS)
    end.record()
    torch.cuda.synchronize()
    k1, k4 = route.counts()
    step_ms = start.elapsed_time(end) / FIT_STEPS
    log(f"{vname}: fit losses {losses}, {step_ms:.4f} ms/step, launches "
        f"{kf} {k1} {kb} {k4} for {FIT_STEPS} steps")
    check(k1 == k4 == FIT_STEPS, f"{vname}: launches {kf} {k1} {kb} {k4}")
    check(all(math.isfinite(v) for v in losses), f"{vname}: loss not finite")
    log(f"{vname}: at lr {FIT_LR:g} the loss after {FIT_STEPS} steps is "
        f"{losses[-1]:.6g} vs {losses[0]:.6g} at the start: "
        f"{'fell' if losses[-1] < losses[0] else 'did not fall'}")
    trace = profile_fit(lambda: run(FIT_STEPS), route.names)
    log(f"{vname}: the same {FIT_STEPS} steps under torch.profiler: "
        f"{trace['wall_ms'] / FIT_STEPS:.4f} ms/step, device busy "
        f"{trace['busy_ms'] / FIT_STEPS:.4f} ms/step ({kf} "
        f"{trace['k1_ms'] / FIT_STEPS:.4f}, {kb} "
        f"{trace['k4_ms'] / FIT_STEPS:.4f}),"
        f" idle {trace['idle_share']:.4f} of the span from the first kernel to "
        f"the last ({trace['span_ms'] / FIT_STEPS:.4f} ms/step), "
        f"{trace['kernels']} device operations")

    # descent: the same start at a step small enough that every update
    # lowers the loss
    route.reset()
    _, descent = run(FIT_STEPS, FIT_DESCENT_LR)
    d1, d4 = route.counts()
    log(f"{vname}: fit losses at lr {FIT_DESCENT_LR:g} {descent}, launches "
        f"{kf} {d1} {kb} {d4}")
    check(d1 == d4 == FIT_STEPS, f"{vname}: launches {kf} {d1} {kb} {d4}")
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
    vjp = route.bwd_mod
    routes = vjp._forward, vjp._backward
    vjp._forward, vjp._backward = route.plain
    try:
        pp, lp = run(2)
    finally:
        vjp._forward, vjp._backward = routes
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


def profile_fit(fn, names) -> dict:
    """Run ``fn`` under torch.profiler -> its wall time, the device time of
    the two kernels ``names`` (forward, backward) and of all device
    operations (their union), and the device's idle share of the span from
    the first device operation to the last."""
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
                k1_ms=kernel_ms(names[0]), k4_ms=kernel_ms(names[1]))


def a5_edge_cases(P, tf, from_text):
    """Edge inputs of the a5 kernels at small shapes -> [(name, volume, tf,
    camera, config, eps)]: odd dims with negative intensities and cal_max
    200.9, the z-wrap and y-wrap scenes of tests/test_pallas_a5.py, a
    z > 127 volume, TF(0).alpha 0.05 and -3e-5, a single-interval table,
    eps 1e-3."""
    rng = np.random.default_rng(5)
    odd = P.make_volume(rng.uniform(-30, 255, (13, 17, 20)).astype(np.float32),
                        cal_max=200.9)
    zwrap = np.zeros((6, 6, 6), np.float32)
    zwrap[2, 3, 0] = zwrap[2, 2, 5] = 150.0
    wraps = np.zeros((6, 6, 130), np.float32)
    wraps[2, 3, 0] = wraps[2, 2, 129] = 150.0
    wraps[3, 0, 64] = wraps[2, 5, 64] = 150.0
    deep = P.make_volume(rng.uniform(-30, 255, (12, 14, 150))
                         .astype(np.float32))
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37,
                           algorithm=P.Algorithm.TEST)
    wrap_cfg = P.RenderConfig(width=16, height=16, samples_per_ray=24,
                              algorithm=P.Algorithm.TEST)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    wrap_cam = P.Camera.initial(position=(0.1, 0.2, 0.95))
    return [
        ("odd_negatives_calmax200.9", odd, tf, near, small, 0.0),
        ("z_wrap", P.make_volume(zwrap), tf, wrap_cam, wrap_cfg, 0.0),
        ("y_and_z_wraps_z130", P.make_volume(wraps), tf, wrap_cam, wrap_cfg,
         0.0),
        ("z150", deep, tf, near, small, 0.0),
        ("alpha0_0.05", odd, tf_with_alpha(P, tf, 0, 0.05), near, small, 0.0),
        ("negative_alpha0", odd, tf_with_alpha(P, tf, 0, -3e-5), near, small,
         0.0),
        ("single_interval_tf", odd, from_text("glass 0 1"), near, small, 0.0),
        ("eps1e-3", odd, tf, near, small, 1e-3),
    ]


def a5_kernel_phases(P, a5, a5_vjp, volumes, tf, edge, rng, per_volume):
    """Phases 3c (K3 against march_a5_plain) and 3d (K6 against
    march_a5_bwd_plain) -> (K3 max abs err, K6 max abs err, K6 max relative
    err); times and bounds go into ``per_volume``."""
    cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                         algorithm=P.Algorithm.TEST)

    def k3_vs_plain(label, a):
        return fwd_vs_plain(a5.march_a5_kernel, a5.march_a5_plain, label, a)

    # ---- 3c. K3 ----------------------------------------------------------
    k3_err = 0.0
    for name, vol, tfx, cam, c, eps in edge:
        _, _, e = k3_vs_plain(f"a5 edge/{name}",
                              a5.prepare_a5(vol, tfx, cam, c, eps))
        k3_err = max(k3_err, e)
    for vname, vol in volumes.items():
        orbit_cam = orbit_cameras(P, rng, 1)[0]
        exact = {}
        for name, cam, eps in (("orbit_eps0", orbit_cam, 0.0),
                               ("orbit_eps1e-3", orbit_cam, 1e-3),
                               ("preset_eps0", P.reset_preset(), 0.0)):
            got, want, e = k3_vs_plain(f"a5 {vname}/{name}",
                                       a5.prepare_a5(vol, tf, cam, cfg, eps))
            k3_err = max(k3_err, e)
            if eps == 0.0:
                exact[id(cam)] = want
                continue
            e2 = float((got - exact[id(cam)]).abs().max())
            log(f"a5 {vname}/{name}: K3 at eps {eps:g} vs exact plain max "
                f"err {e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"a5 {vname}/{name}: eps error {e2}")

        # K3 and plain times and the bound, at the render path's inputs
        cams = orbit_cameras(P, rng)
        main_cfg = cfg.replace(early_termination=1e-3)
        args = [a5.prepare_a5(vol, tf, cam, main_cfg, 1e-3) for cam in cams]

        def orbit_kernels():
            for a in args:
                a5.march_a5_kernel(a)

        k3_ms = timed_ms(orbit_kernels, 5, prefill=True,
                         label=f"a5 {vname}: K3 x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: a5.prepare_a5(vol, tf, cams[0], main_cfg,
                                                 1e-3), 5)
        samples = samples_needed(a5.march_a5_plain, args)
        plain_ms = timed_ms(lambda: a5.march_a5_plain(args[0]), 1)
        rays = A5_W * A5_H
        nbytes = math.prod(vol.dims) + args[0].colors.numel() * 4 + rays * 16
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            samples * FLOPS_PER_A5_SAMPLE + rays * FLOPS_PER_A5_RAY, nbytes)
        per_volume[vname].update(
            a5_ms=k3_ms, a5_plain_ms=plain_ms, a5_prep_ms=prep_ms,
            a5_bound_ms=bound_ms, a5_bound_by=bound_by, a5_samples=samples)
        log(f"a5 {vname}: K3 {k3_ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
            f"{prep_ms:.4f} ms, needed samples per frame {samples}, bound "
            f"{ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes)")

    # ---- 3d. K6 ----------------------------------------------------------
    grad_rng = np.random.default_rng(6)
    k6_abs = k6_rel = 0.0

    def k6_vs_plain(label, a, g):
        return bwd_vs_plain(a5_vjp.march_a5_bwd_kernel,
                            a5_vjp.march_a5_bwd_plain, label, a, g)

    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    odd = edge[0][1]
    small = edge[0][4]
    for name, vol, tfx, cam, c, _ in edge + [
            ("alpha_one", odd, tf_with_alpha(P, tf, 3, 1.0), near, small,
             0.0),
            ("k16", odd, tf16(P, tf.colors.device), near, small, 0.0)]:
        a, _ = a5_vjp.prepare_a5_diff(vol, tfx, cam, c)
        e_abs, e_rel = k6_vs_plain(f"a5 edge/{name}", a, cotangents(a,
                                                                 grad_rng))
        k6_abs, k6_rel = max(k6_abs, e_abs), max(k6_rel, e_rel)
    bwd_cam = orbit_cameras(P, np.random.default_rng(7), 1)[0]
    for vname, vol in volumes.items():
        a, _ = a5_vjp.prepare_a5_diff(vol, tf, bwd_cam, cfg)
        g = cotangents(a, grad_rng)
        e_abs, e_rel = k6_vs_plain(f"a5 {vname}/orbit", a, g)
        k6_abs, k6_rel = max(k6_abs, e_abs), max(k6_rel, e_rel)
        k6_ms = timed_ms(lambda: a5_vjp.march_a5_bwd_kernel(a, *g), 5,
                         prefill=True, label=f"a5 {vname}: K6")
        k6_plain_ms = timed_ms(lambda: a5_vjp.march_a5_bwd_plain(a, *g), 1)
        k3_eps0_ms = timed_ms(lambda: a5.march_a5_kernel(a), 5, prefill=True)
        k = a.colors.shape[0]
        rays = A5_W * A5_H
        # at eps 0 no ray stops early: the samples inside the volume
        inside = samples_needed(a5.march_a5_plain, [a])
        nbytes = (math.prod(vol.dims) + rays * 16 + k * 16
                  + a5_vjp.num_blocks(A5_W, A5_H) * k * 16)
        ops = (inside * (FLOPS_PER_A5_BWD_SAMPLE
                         + min(8, k) * FLOPS_PER_A5_BWD_SAMPLE_PER_INTERVAL)
               + (rays * A5_SPR - inside) * FLOPS_PER_BWD_OUTSIDE_SAMPLE
               + rays * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                         + FLOPS_PER_A5_BWD_RAY))
        bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
        per_volume[vname].update(
            a5_bwd_ms=k6_ms, a5_bwd_plain_ms=k6_plain_ms,
            a5_fwd_eps0_ms=k3_eps0_ms, a5_bwd_bound_ms=bound_ms,
            a5_bwd_bound_by=bound_by, a5_bwd_inside=inside)
        log(f"a5 {vname}: K6 {k6_ms:.4f} ms, plain {k6_plain_ms:.2f} ms, K3 "
            f"at eps 0 {k3_eps0_ms:.4f} ms, samples inside the volume "
            f"{inside} of {rays * A5_SPR}, bound {ops_ms:.4f} ms (operations)"
            f" / {bytes_ms:.4f} ms (bytes)")
    return k3_err, k6_abs, k6_rel


def a5_render_phase(P, a5, volumes, tf, rng, per_volume) -> int:
    """Phase 4b: 8 orbit frames per volume through ``render()`` with
    Algorithm.TEST at eps 1e-3 -> K3's launches, which must equal the
    frames."""
    import torch

    cfg = P.RenderConfig(width=A5_W, height=A5_H, samples_per_ray=A5_SPR,
                         algorithm=P.Algorithm.TEST, early_termination=1e-3)
    frames = 0
    a5.launches = 0
    for vname, vol in volumes.items():
        cams = orbit_cameras(P, rng)
        P.render(vol, tf, cams[-1], cfg)  # warm-up frame
        frames += 1
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
        end.record()
        torch.cuda.synchronize()
        frames += len(imgs)
        ms = start.elapsed_time(end) / len(imgs)
        for img in imgs:
            check(tuple(img.shape) == (A5_W, A5_H, 4),
                  f"a5 {vname}: shape {img.shape}")
            check(bool(torch.isfinite(img).all()), f"a5 {vname}: not finite")
            fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                       .float().mean())
            check(fg > 0.01, f"a5 {vname}: image is background only ({fg})")
        per_volume[vname]["a5_render_ms"] = ms
        log(f"a5 {vname}: render() {ms:.4f} ms/frame, "
            f"{A5_W * A5_H / ms * 1e3:.4e} rays/s")
    launches = a5.launches
    log(f"K3 launches on the a5 render path: {launches} for {frames} frames")
    check(launches == frames, f"a5 launches {launches} != frames {frames}")
    return launches


def a5_cli_phase(tmp: str, tf, from_text) -> None:
    """Phases 5c and 5d: the CLI ``render`` and ``fit`` with
    ``--algorithm test``."""
    import torch

    size = ["--width", str(A5_W), "--height", str(A5_H), "--spr", str(A5_SPR)]
    out = os.path.join(tmp, "sphere_a5.png")
    proc = subprocess.run(
        [sys.executable, "-m", "volumerenderingproject_tpu_torch", "render",
         "--data", "sphere", *size, "--algorithm", "test", "--out", out],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    log(f"cli a5 render exit {proc.returncode}: {proc.stdout.strip()} "
        f"{proc.stderr.strip()[-2000:]}")
    check(proc.returncode == 0, "cli a5 render failed")
    check_png(out, A5_W, A5_H)
    out_tf = os.path.join(tmp, "fitted_a5.txt")
    proc = subprocess.run(
        [sys.executable, "-m", "volumerenderingproject_tpu_torch", "fit",
         "--data", "sphere", *size, "--algorithm", "test", "--target", out,
         "--steps", "3", "--out-tf", out_tf],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    log(f"cli a5 fit exit {proc.returncode}: {proc.stdout.strip()} "
        f"{proc.stderr.strip()[-2000:]}")
    check(proc.returncode == 0, "cli a5 fit failed")
    with open(out_tf) as f:
        fitted = from_text(f.read())
    check(fitted.num_intervals == tf.num_intervals
          and bool(torch.isfinite(fitted.colors).all()),
          "cli a5 fit wrote a bad transfer function")


def reset_launches(*mods) -> None:
    """Set each kernel module's launch counts, in all and by variant, to 0."""
    for m in mods:
        m.launches = 0
        m.variant_launches = dict.fromkeys(m.variant_launches, 0)


def bound_bytes(a, rays: int) -> int:
    """Bytes a march must move: its id grid, brick map (a1), colours, baked
    grids and output, each once."""
    n = a.ids.numel() * a.ids.element_size() + a.colors.numel() * 4 + rays * 16
    occ = getattr(a, "occ", None)  # the a5 march has no brick map
    if occ is not None:
        n += occ.numel() * 4
    if a.mgrid is not None:
        n += (a.mgrid.numel() + a.sgrid.numel()) * 4
    return n


def exact_vs_plain(kernel, plain, label, a):
    """A kernel variant of this slice against its plain version: it must be
    bit-exact -> (kernel image, plain image, max abs error)."""
    import torch

    got = kernel(a)
    want = plain(a)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: not finite")
    e = float((got - want).abs().max())
    log(f"{label}: kernel vs plain max err {e:.3e} (must be 0)")
    check(e == 0.0, f"{label}: max err {e}")
    return got, want, e


def lit_edge_tfs(P, tf, from_text):
    """(TF with a bound on a 256-entry LUT grid point, TF(0).alpha -3e-5)."""
    pts = np.arange(256, dtype=np.float32) * (np.float32(1) / np.float32(255))
    bound = from_text(f"empty 0 1 0.1 0.1 0.1 0\n"
                      f"edge {float(pts[40])!r} {float(pts[90])!r} 1 0.4 0.2 "
                      f"0.3\nbone 0.5 0.7 0.9 0.9 0.8 0.6\n")
    return bound, tf_with_alpha(P, tf, 0, -3e-5)


def lit_kernel_phases(P, march, a5, phong, volumes, tf, from_text, rng,
                      per_volume):
    """Phases 3e (K1's LUT, baked and LUT + baked variants against
    march_plain) and 3f (K3 baked against march_a5_plain) -> {variant: max
    abs err}; times, bakes and bounds go into ``per_volume``."""
    import torch

    errs = {"lut": 0.0, "baked": 0.0, "lut_baked": 0.0, "a5_baked": 0.0}
    edge_rng = np.random.default_rng(10)
    odd = P.make_volume(edge_rng.uniform(-30, 255, (13, 17, 20))
                        .astype(np.float32), cal_max=200.9)
    small = P.RenderConfig(width=61, height=37, samples_per_ray=37)
    near = P.Camera.initial(position=(0.35, 0.45, 0.85))
    far = P.Camera.initial(position=(0.9, 0.5, 1.0))  # most rays miss
    tf_bound, tf_neg = lit_edge_tfs(P, tf, from_text)
    lit = small.replace(lighting=True)
    edges = [
        ("lut2", tf, near, small.replace(tf_lut=2)),
        ("lut96_rays_miss_box", tf, far, small.replace(tf_lut=96)),
        ("lut256_bound_on_grid_point", tf_bound, near,
         small.replace(tf_lut=256)),
        ("lut256_negative_alpha0", tf_neg, near, small.replace(tf_lut=256)),
        ("lut1024", tf, near, small.replace(tf_lut=1024)),
        ("baked_central", tf, near, lit),
        ("baked_sobel_presmooth", tf, near,
         lit.replace(gradient_filter="sobel", presmooth_sigma=1.0)),
        ("baked_negative_alpha0", tf_neg, near, lit),
        ("baked_rays_miss_box", tf, far, lit),
        ("baked_front_clip_density", tf, near,
         lit.replace(front_clip=0.5, density_scale=0.45)),
        ("lut_baked_2", tf, near, lit.replace(tf_lut=2)),
        ("lut_baked_bound_on_grid_point", tf_bound, near,
         lit.replace(tf_lut=256)),
        ("lut_baked_negative_alpha0", tf_neg, near, lit.replace(tf_lut=96)),
        ("lut_baked_rays_miss_box", tf, far, lit.replace(tf_lut=256)),
        ("lut_baked_1024_sobel", tf, near,
         lit.replace(tf_lut=1024, gradient_filter="sobel")),
    ]
    # ---- 3e. K1 variants -------------------------------------------------
    for name, tfx, cam, c in edges:
        a = march.prepare(odd, tfx, cam, c, 0.0)
        var = march.variant(a)
        e = exact_vs_plain(march.march_kernel, march.march_plain,
                           f"lit edge/{name} ({var})", a)[2]
        errs[var] = max(errs[var], e)
    for vname, vol in volumes.items():
        for cname, kw in LIT_CONFIGS.items():
            cfg = P.RenderConfig(**kw)
            cam = orbit_cameras(P, rng, 1)[0]
            a = march.prepare(vol, tf, cam, cfg, 0.0)
            var = march.variant(a)
            label = f"{vname}/{cname} ({var})"
            _, exact, e = exact_vs_plain(
                march.march_kernel, march.march_plain, f"{label} eps0", a)
            errs[var] = max(errs[var], e)
            got = march.march_kernel(march.prepare(vol, tf, cam, cfg, 1e-3))
            e2 = float((got - exact).abs().max())
            log(f"{label}: kernel at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")

            # times, the bake and the bound at the render path's inputs
            main_cfg = cfg.replace(early_termination=1e-3)
            cams = orbit_cameras(P, rng)
            args = [march.prepare(vol, tf, c, main_cfg, 1e-3) for c in cams]

            def orbit_kernels():
                for x in args:
                    march.march_kernel(x)

            ms = timed_ms(orbit_kernels, 5, prefill=True,
                          label=f"{label}: kernel x{FRAMES}") / FRAMES
            prep_ms = timed_ms(lambda: march.prepare(vol, tf, cams[0],
                                                     main_cfg, 1e-3), 3)
            bake_ms = 0.0
            if cfg.lighting:
                light = phong.default_light()
                bake_ms = timed_ms(lambda: phong.bake_light_grids(
                    vol.data, cfg, light, -cams[0].front), 3)
            samples = samples_needed(march.march_plain, args)
            plain_ms = timed_ms(lambda: march.march_plain(args[0]), 1)
            rays = cfg.width * cfg.height
            ops = samples * (FLOPS_PER_SAMPLE + (
                FLOPS_PER_BAKED_SAMPLE if cfg.lighting else 0))
            bound_ms, bound_by, ops_ms, bytes_ms = bound(
                ops, bound_bytes(args[0], rays))
            per_volume[vname][cname] = dict(
                variant=var, ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
                bake_ms=bake_ms, bound_ms=bound_ms, bound_by=bound_by,
                samples=samples)
            log(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, prep "
                f"{prep_ms:.4f} ms (bake {bake_ms:.4f} ms), needed samples per"
                f" frame {samples}, bound {ops_ms:.4f} ms (operations) / "
                f"{bytes_ms:.4f} ms (bytes)")
            del args
            torch.cuda.empty_cache()

    # ---- 3f. K3 baked ----------------------------------------------------
    for name, vol, tfx, cam, c, eps in a5_edge_cases(P, tf, from_text):
        a = a5.prepare_a5(vol, tfx, cam, c.replace(lighting=True), eps)
        e = exact_vs_plain(a5.march_a5_kernel, a5.march_a5_plain,
                           f"a5 lit edge/{name}", a)[2]
        errs["a5_baked"] = max(errs["a5_baked"], e)
    for vname, vol in volumes.items():
        cfg = P.RenderConfig(algorithm=P.Algorithm.TEST, **A5_LIT)
        cam = orbit_cameras(P, rng, 1)[0]
        for gname, c in (("central", cfg),
                         ("sobel", cfg.replace(gradient_filter="sobel"))):
            label = f"a5 {vname}/a5_lit_300_{gname}"
            _, exact, e = exact_vs_plain(
                a5.march_a5_kernel, a5.march_a5_plain, f"{label} eps0",
                a5.prepare_a5(vol, tf, cam, c, 0.0))
            errs["a5_baked"] = max(errs["a5_baked"], e)
            got = a5.march_a5_kernel(a5.prepare_a5(vol, tf, cam, c, 1e-3))
            e2 = float((got - exact).abs().max())
            log(f"{label}: K3 baked at eps 1e-3 vs exact plain max err "
                f"{e2:.3e} (tol {TOL_EPS:g})")
            check(e2 <= TOL_EPS, f"{label}: eps error {e2}")
        main_cfg = cfg.replace(early_termination=1e-3)
        cams = orbit_cameras(P, rng)
        args = [a5.prepare_a5(vol, tf, c, main_cfg, 1e-3) for c in cams]

        def orbit_a5():
            for x in args:
                a5.march_a5_kernel(x)

        ms = timed_ms(orbit_a5, 5, prefill=True,
                      label=f"a5 {vname}: K3 baked x{FRAMES}") / FRAMES
        prep_ms = timed_ms(lambda: a5.prepare_a5(vol, tf, cams[0], main_cfg,
                                                 1e-3), 3)
        light = phong.default_light()
        bake_ms = timed_ms(lambda: phong.bake_light_grids(
            vol.data, cfg, light, -cams[0].front), 3)
        samples = samples_needed(a5.march_a5_plain, args)
        plain_ms = timed_ms(lambda: a5.march_a5_plain(args[0]), 1)
        rays = cfg.width * cfg.height
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            samples * (FLOPS_PER_A5_SAMPLE + FLOPS_PER_BAKED_SAMPLE)
            + rays * FLOPS_PER_A5_RAY, bound_bytes(args[0], rays))
        per_volume[vname]["a5_lit_300"] = dict(
            variant="a5_baked", ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
            bake_ms=bake_ms, bound_ms=bound_ms, bound_by=bound_by,
            samples=samples)
        log(f"a5 {vname}/a5_lit_300: K3 baked {ms:.4f} ms, plain "
            f"{plain_ms:.2f} ms, prep {prep_ms:.4f} ms (bake {bake_ms:.4f} "
            f"ms), needed samples per frame {samples}, bound {ops_ms:.4f} ms "
            f"(operations) / {bytes_ms:.4f} ms (bytes)")
        del args
        torch.cuda.empty_cache()
    return errs


def lit_render_phase(P, march, a5, volumes, tf, rng, per_volume) -> dict:
    """Phase 4c: 8 orbit frames per volume and lit config through
    ``render()`` after one warm-up -> the launches of each new variant,
    which must equal that variant's frames."""
    import torch

    configs = [(name, P.RenderConfig(early_termination=1e-3, **kw))
               for name, kw in LIT_CONFIGS.items()]
    configs.append(("a5_lit_300", P.RenderConfig(
        algorithm=P.Algorithm.TEST, early_termination=1e-3, **A5_LIT)))
    frames = {}
    reset_launches(march, a5)
    for cname, cfg in configs:
        for vname, vol in volumes.items():
            cams = orbit_cameras(P, rng)
            P.render(vol, tf, cams[-1], cfg)  # warm-up frame
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            imgs = [P.render(vol, tf, cam, cfg) for cam in cams]
            end.record()
            torch.cuda.synchronize()
            var = per_volume[vname][cname]["variant"]
            frames[var] = frames.get(var, 0) + len(imgs) + 1
            ms = start.elapsed_time(end) / len(imgs)
            for img in imgs:
                check(tuple(img.shape) == (cfg.width, cfg.height, 4),
                      f"{vname}/{cname}: shape {img.shape}")
                check(bool(torch.isfinite(img).all()),
                      f"{vname}/{cname}: not finite")
                fg = float(((img[..., :3] - 0.2).abs().amax(-1) > 0.05)
                           .float().mean())
                check(fg > 0.01, f"{vname}/{cname}: background only ({fg})")
            r = per_volume[vname][cname]
            r["render_ms"] = ms
            log(f"{vname}/{cname}: render() {ms:.4f} ms/frame, "
                f"{cfg.width * cfg.height / ms * 1e3:.4e} rays/s; bake "
                f"{r['bake_ms']:.4f} ms, prep {r['prep_ms']:.4f} ms, kernel "
                f"{r['ms']:.4f} ms, plain {r['plain_ms']:.2f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    launches = {"lut": march.variant_launches["lut"],
                "baked": march.variant_launches["baked"],
                "lut_baked": march.variant_launches["lut_baked"],
                "a5_baked": a5.variant_launches["baked"]}
    log(f"lit render path launches by variant: {launches}, frames {frames}; "
        f"K1 plain {march.variant_launches['plain']}, K3 unlit "
        f"{a5.variant_launches['unlit']}")
    check(launches == frames, f"lit launches {launches} != frames {frames}")
    check(march.variant_launches["plain"] == 0
          and a5.variant_launches["unlit"] == 0,
          "a lit or LUT render launched an unlit variant")
    return launches


def lit_cli_phase(tmp: str) -> None:
    """Phase 5e: the CLI's lit and ``--config`` renders, a1 and a5."""
    cfg_path = os.path.join(tmp, "lut_phong.json")
    with open(cfg_path, "w") as f:
        json.dump({"width": 300, "height": 300, "samples_per_ray": 300,
                   "tf_lut": 256}, f)
    sobel = ["--width", "700", "--height", "700", "--spr", "250",
             "--lighting", "--gradient-filter", "sobel"]
    for name, flags, size in (
            ("sobel_a1", sobel, 700),
            ("sobel_a5", sobel + ["--algorithm", "test"], 700),
            ("config_lut_a1", ["--config", cfg_path, "--lighting"], 300),
            ("config_lut_a5", ["--config", cfg_path, "--lighting",
                               "--algorithm", "test"], 300)):
        out = os.path.join(tmp, f"{name}.png")
        proc = subprocess.run(
            [sys.executable, "-m", "volumerenderingproject_tpu_torch",
             "render", "--data", "sphere", *flags, "--out", out],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        log(f"cli {name} exit {proc.returncode}: {proc.stdout.strip()} "
            f"{proc.stderr.strip()[-2000:]}")
        check(proc.returncode == 0, f"cli {name} failed")
        check_png(out, size, size)


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
    from volumerenderingproject_tpu_torch.ops import (
        _build, a5, a5_vjp, march, march_vjp, phong)
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
    a5._kernel_lib()
    a5_vjp._kernel_lib()
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
        return fwd_vs_plain(march.march_kernel, march.march_plain, label, a,
                            conic)

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
        samples = samples_needed(march.march_plain, args)
        plain_ms = timed_ms(lambda: march.march_plain(args[0]), 2)
        voxels = math.prod(vol.dims)
        nbytes = (voxels + args[0].occ.numel() * 4 + args[0].colors.numel() * 4
                  + W * H * 16)
        bound_ms, bound_by, ops_ms, bytes_ms = bound(
            samples * FLOPS_PER_SAMPLE, nbytes)
        per_volume[vname] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 samples=samples)
        log(f"{vname}: march kernel {kernel_ms:.4f} ms, plain {plain_ms:.2f} ms,"
            f" prep {prep_ms:.4f} ms, needed samples per frame {samples}, "
            f"bound {ops_ms:.4f} ms (operations) / {bytes_ms:.4f} ms (bytes)")

    # ---- 3b. the backward kernel vs plain on the card ------------------------
    grad_rng = np.random.default_rng(2)
    bwd_abs = bwd_rel = 0.0
    for name, tfx, cam, c, _ in edge_cases + [
            ("alpha_one", tf_with_alpha(P, tf, 3, 1.0), near, small, 0.0),
            ("negative_alpha0", tf_neg, near, small, 0.0),
            ("k16", tf16(P, tf.colors.device), near, small, 0.0),
            ("density_0.45", tf, near, small.replace(density_scale=0.45), 0.0)]:
        a, _ = march_vjp.prepare_diff(odd, tfx, cam, c)
        e_abs, e_rel = bwd_vs_plain(
            march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
            f"edge/{name}", a, cotangents(a, grad_rng))
        bwd_abs, bwd_rel = max(bwd_abs, e_abs), max(bwd_rel, e_rel)
    bwd_cam = orbit_cameras(P, np.random.default_rng(3), 1)[0]
    for vname, vol in volumes.items():
        for name, cam, c in (
                ("ortho_orbit", bwd_cam, cfg),
                ("conic", P.Camera.initial(position=(0.9, 0.5, 1.0)),
                 cfg.replace(conic=True))):
            a, _ = march_vjp.prepare_diff(vol, tf, cam, c)
            g = cotangents(a, grad_rng)
            e_abs, e_rel = bwd_vs_plain(
                march_vjp.march_bwd_kernel, march_vjp.march_bwd_plain,
                f"{vname}/{name}", a, g)
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
            # at eps 0 no ray stops early: the samples inside the volume
            inside = samples_needed(march.march_plain, [a])
            nbytes = (math.prod(vol.dims) + W * H * 16 + k * 16
                      + march_vjp.num_blocks(W, H) * k * 16)
            ops = (inside * FLOPS_PER_BWD_SAMPLE
                   + (samples - inside) * FLOPS_PER_BWD_OUTSIDE_SAMPLE
                   + W * H * (k * FLOPS_PER_BWD_RAY_PER_INTERVAL
                              + FLOPS_PER_BWD_RAY))
            bound_ms, bound_by, ops_ms, bytes_ms = bound(ops, nbytes)
            per_volume[vname].update(
                bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms,
                fwd_eps0_ms=fwd_eps0_ms, bwd_bound_ms=bound_ms,
                bwd_bound_by=bound_by, bwd_inside=inside)
            log(f"{vname}: backward kernel {bwd_ms:.4f} ms, plain "
                f"{bwd_plain_ms:.2f} ms, forward kernel at eps 0 "
                f"{fwd_eps0_ms:.4f} ms, samples inside the volume {inside} "
                f"of {samples}, bound {ops_ms:.4f} ms (operations) / "
                f"{bytes_ms:.4f} ms (bytes)")

    # ---- 3c, 3d. the a5 kernels (K3, K6) vs plain on the card ---------------
    a5_rng = np.random.default_rng(8)
    a5_edge = a5_edge_cases(P, tf, from_text)
    k3_err, k6_abs, k6_rel = a5_kernel_phases(
        P, a5, a5_vjp, volumes, tf, a5_edge, a5_rng, per_volume)

    # ---- 3e, 3f. the lit and LUT variants of K1 and K3 vs plain ------------
    lit_rng = np.random.default_rng(11)
    lit_errs = lit_kernel_phases(P, march, a5, phong, volumes, tf, from_text,
                                 lit_rng, per_volume)

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

    # ---- 4b. the a5 render path ---------------------------------------------
    a5_launches = a5_render_phase(P, a5, volumes, tf, a5_rng, per_volume)

    # ---- 4c. the lit render paths -------------------------------------------
    lit_launches = lit_render_phase(P, march, a5, volumes, tf, lit_rng,
                                    per_volume)

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

        # ---- 5c, 5d. the CLI render and fit with --algorithm test ----------
        a5_cli_phase(tmp, tf, from_text)

        # ---- 5e. the CLI's lit and LUT renders ------------------------------
        lit_cli_phase(tmp)

    # ---- 6. a small input against the reference scan ----------------------
    small = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    sphere = volumes["sphere100"]
    got = P.render(sphere, tf, P.reset_preset(), small)
    ref = P.render(sphere, tf, P.reset_preset(), small, mode="reference")
    e = float((got - ref).abs().max())
    log(f"sphere 100x100x100: kernel vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"kernel vs reference scan: {e}")

    # ---- 6b. a small a5 input against the a5 reference scan ---------------
    small_a5 = small.replace(algorithm=P.Algorithm.TEST)
    got = P.render(sphere, tf, P.reset_preset(), small_a5)
    ref = P.render(sphere, tf, P.reset_preset(), small_a5, mode="reference")
    e = float((got - ref).abs().max())
    log(f"a5 sphere 100x100x100: K3 vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"K3 vs a5 reference scan: {e}")

    # ---- 6c. small lit inputs against the reference scans -----------------
    for name, c in (("a1 lit", small.replace(lighting=True)),
                    ("a1 lit LUT 256", small.replace(lighting=True,
                                                     tf_lut=256)),
                    ("a5 lit", small_a5.replace(lighting=True))):
        got = P.render(sphere, tf, P.reset_preset(), c)
        ref = P.render(sphere, tf, P.reset_preset(), c, mode="reference")
        e = float((got - ref).abs().max())
        log(f"{name} sphere 100x100x100: kernel vs back-to-front reference "
            f"max err {e:.3e} (tol {TOL_EXACT:g})")
        check(e <= TOL_EXACT, f"{name} kernel vs reference scan: {e}")

    # ---- 7. the fit path -----------------------------------------------------
    fit_rng = np.random.default_rng(4)
    fit_launches = {"k1": 0, "k4": 0}
    a1_route = FitRoute(("K1", "K4"), march, march_vjp,
                        march.march_plain, march_vjp.march_bwd_plain,
                        "march_a1_kernel", "march_bwd_a1_kernel")
    for vname, vol in volumes.items():
        r = fit_phase(P, fit, a1_route, vname, vol, fit_rng,
                      P.RenderConfig(width=W, height=H, samples_per_ray=SPR))
        per_volume[vname]["fit_step_ms"] = r["step_ms"]
        per_volume[vname]["fit_idle_share"] = r["trace"]["idle_share"]
        fit_launches["k1"] += r["k1"]
        fit_launches["k4"] += r["k4"]
    log(f"march kernel launches on the fit path: {fit_launches['k1']}, "
        f"backward kernel launches: {fit_launches['k4']} "
        f"({FIT_STEPS} steps per volume)")

    # ---- 7b. the a5 fit path -------------------------------------------------
    a5_route = FitRoute(("K3", "K6"), a5, a5_vjp, a5.march_a5_plain,
                        a5_vjp.march_a5_bwd_plain, "march_a5_kernel",
                        "march_bwd_a5_kernel")
    a5_fit_rng = np.random.default_rng(9)
    a5_fit = {"k3": 0, "k6": 0}
    for vname, vol in volumes.items():
        r = fit_phase(P, fit, a5_route, f"a5 {vname}", vol, a5_fit_rng,
                      P.RenderConfig(width=A5_W, height=A5_H,
                                     samples_per_ray=A5_SPR,
                                     algorithm=P.Algorithm.TEST))
        per_volume[vname]["a5_fit_step_ms"] = r["step_ms"]
        per_volume[vname]["a5_fit_idle_share"] = r["trace"]["idle_share"]
        a5_fit["k3"] += r["k1"]
        a5_fit["k6"] += r["k4"]
    log(f"K3 launches on the a5 fit path: {a5_fit['k3']}, K6 launches: "
        f"{a5_fit['k6']} ({FIT_STEPS} steps per volume)")

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
    }, {
        "name": "march_a5",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/a5.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_a5.py:67",
        "launches": a5_launches + a5_fit["k3"],
        "max_abs_err": k3_err,
        "ms": main_vol["a5_ms"],
        "plain_ms": main_vol["a5_plain_ms"],
        "bound_ms": main_vol["a5_bound_ms"],
        "bound_by": main_vol["a5_bound_by"],
        "library_ms": None,
    }, {
        "name": "march_bwd_a5",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/a5_bwd.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_a5.py:1128",
        "launches": a5_fit["k6"],
        "max_abs_err": k6_abs,
        "ms": main_vol["a5_bwd_ms"],
        "plain_ms": main_vol["a5_bwd_plain_ms"],
        "bound_ms": main_vol["a5_bwd_bound_ms"],
        "bound_by": main_vol["a5_bwd_bound_by"],
        "library_ms": None,
    }]
    for var, cname, src, line in (
            ("lut", "lut_300", "march.cu", "pallas_march.py:103"),
            ("baked", "sobel_lit_700", "march.cu", "pallas_march.py:103"),
            ("lut_baked", "lut_phong_300", "march.cu", "pallas_march.py:103"),
            ("a5_baked", "a5_lit_300", "a5.cu", "pallas_a5.py:67")):
        r = main_vol[cname]
        kernels.append({
            "name": "march_a5_baked" if var == "a5_baked"
            else f"march_a1_{var}",
            "route": "cuda",
            "source": f"volumerenderingproject_tpu_torch/csrc/{src}",
            "replaces": f"volumerenderingproject_tpu/ops/{line}",
            "launches": lit_launches[var],
            "max_abs_err": lit_errs[var],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    log(f"per volume: {json.dumps(per_volume)}")
    log(f"backward kernel max relative err over all cases {bwd_rel:.3e}")
    log(f"K6 max relative err over all cases {k6_rel:.3e}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
