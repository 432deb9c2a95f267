#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``volumerenderingproject_tpu_torch``).

    python3 chip_smoke.py        # from the repository root, on a machine with one CUDA GPU

Phases, each of which exits non-zero on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from ``csrc/`` (nvcc, in parallel);
  3. each kernel against its plain PyTorch version on the card: on edge
     inputs at small shapes, then at the main path's shapes (700x700
     pixels, 500 samples per ray) on two volumes:
     ``centered_sphere(100)`` and a seeded 182x218x182 volume (MNI152-1mm
     dims) of nested ellipsoid shells plus noise, so every interval of the
     default transfer function occurs;
  4. the main path: 8 orbit frames per volume through ``render()`` (the
     bench.py orbit, radius 1.5, early_termination=1e-3), with the kernels'
     launch counts set to 0 just before and read just after;
  5. the CLI: ``python -m volumerenderingproject_tpu_torch render ...``
     must write a valid 700x700 PNG;
  6. the kernel's render of a small input against the back-to-front
     reference scan.

The line before the last is a JSON object ``{"kernels": [...]}`` with each
kernel's launches on the main path, its error against its plain version, its
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
CONIC_PIXEL_SHARE = 0.999  # conic: share of pixels within TOL_EXACT
# H100 SXM peaks (NVIDIA data sheet, at 700 W): float32 outside the tensor
# cores and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# float operations one march sample costs: position 9, nearest-voxel index
# 18, time step 2, compositing 9 (csrc/march.cu)
FLOPS_PER_SAMPLE = 38


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


def timed_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA GPU")
        return 2
    sys.path.insert(0, ROOT)
    import volumerenderingproject_tpu_torch as P
    from volumerenderingproject_tpu_torch.ingest import synthetic
    from volumerenderingproject_tpu_torch.ops import _build, march
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
    for name, tfx, cam, c, eps in (
        ("front_clip", tf, near, small.replace(front_clip=0.5), 0.0),
        ("overlapping_tf_density", overlap, P.reset_preset(),
         small.replace(density_scale=0.45), 0.0),
        ("single_interval_tf", from_text("glass 0 1"), near, small, 0.0),
        ("conic_inside_volume", tf, P.Camera.initial(position=(0.1, 0.05, 0.2)),
         small.replace(conic=True), 0.0),
        ("no_skipping_eps1e-3", tf, P.reset_preset(),
         small.replace(empty_space_skipping=False), 1e-3),
    ):
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

        kernel_ms = timed_ms(orbit_kernels, 5) / FRAMES
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

    # ---- 4. the main path ---------------------------------------------------
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

    # ---- 6. a small input against the reference scan ----------------------
    small = P.RenderConfig(width=100, height=100, samples_per_ray=100)
    sphere = volumes["sphere100"]
    got = P.render(sphere, tf, P.reset_preset(), small)
    ref = P.render(sphere, tf, P.reset_preset(), small, mode="reference")
    e = float((got - ref).abs().max())
    log(f"sphere 100x100x100: kernel vs back-to-front reference max err "
        f"{e:.3e} (tol {TOL_EXACT:g})")
    check(e <= TOL_EXACT, f"kernel vs reference scan: {e}")

    main_vol = per_volume["mni_dims_182x218x182"]
    kernels = [{
        "name": "march_a1",
        "route": "cuda",
        "source": "volumerenderingproject_tpu_torch/csrc/march.cu",
        "replaces": "volumerenderingproject_tpu/ops/pallas_march.py:103",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_vol["ms"],
        "plain_ms": main_vol["plain_ms"],
        "bound_ms": main_vol["bound_ms"],
        "bound_by": main_vol["bound_by"],
        "library_ms": None,
    }]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
