"""Recover the unrecorded cameras behind the reference's golden captures.

The reference's image_output/*.png screenshots were taken after interactive
WASD/QE wandering (myApp.cu:1078-1112) and the camera state was never
recorded.  The reachable camera manifold is small: the camera always looks
at the origin, so a state is (direction on S^2, roll about front, radius),
and radius barely matters in the orthographic mode the captures used.  This
module searches that manifold for the camera maximizing the normalized
cross-correlation (NCC) with each golden.

Search: a Fibonacci-sphere x roll coarse sweep, each candidate rendered
through ``render()`` on the device (the route resolved once: K1 for a1, K3
for a5) with its NCC reduced there, the scores of a chunk of candidates
copied to the host at once; then coordinate-descent refinement at the
golden's native resolution.  Counterpart of
``volumerenderingproject_tpu/harness/camera_recovery.py``, whose records
(``goldens/recovered_cameras.json``) it writes in the same format.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ingest.volume import Volume
from ..scene.camera import Camera
from ..scene.transfer_function import TransferFunction
from ..utils import transforms as T
from ..utils.config import Algorithm, RenderConfig
from ..utils.device import resolve_device
from ..utils.imageio import from_display, load_png
from . import goldens as gold

_f32 = torch.float32
# candidates scored between two copies of their scores to the host
CHUNK = 512

ALGO_BY_ID = {1: Algorithm.VRC, 5: Algorithm.TEST, 0: Algorithm.POINT}


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis as XLA compiles ``jnp.linalg.norm`` on the
    CPU: the squares folded into the sum as fused multiply-adds, s = x^2,
    s = fma(y, y, s), s = fma(z, z, s), each taken in float64 (a product
    of two float32 is exact there) and rounded once, then the float32
    square root; the same on the CPU and the GPU.  Three rounded squares
    summed leave XLA's norm by an ulp on one vector in ten."""
    f64 = torch.float64
    s = v[..., 0] * v[..., 0]
    for k in (1, 2):
        x = v[..., k].to(f64)
        s = (x * x + s.to(f64)).to(_f32)
    return torch.sqrt(s)


def angles_to_camera(theta, phi, roll, radius=1.0, device=None) -> Camera:
    """The orbit camera at spherical direction (theta from +y, phi around
    y) with ``roll`` about the view axis: the reference's reachable states
    (always looking at the origin, utils.h:41-46 basis + accumulated WASD
    roll).  The angles are numbers or tensors of one shape [...]; the
    camera's fields are [..., 3] on ``device`` (CUDA unless given, or the
    angles' device where they are tensors)."""
    if isinstance(theta, torch.Tensor):
        dev = theta.device
    else:
        dev = resolve_device(device)
    theta, phi, roll = (torch.as_tensor(a, dtype=_f32, device=dev)
                        for a in (theta, phi, roll))

    def sin(a):  # float64 and rounded once: the same on the CPU and GPU
        return torch.sin(a.double()).float()

    def cos(a):
        return torch.cos(a.double()).float()

    st = sin(theta)
    dirv = torch.stack([st * cos(phi), cos(theta), st * sin(phi)], dim=-1)
    pos = torch.as_tensor(radius, dtype=_f32, device=dev) * dirv
    front = -dirv
    wu = torch.tensor([0.0, 1.0, 0.0], dtype=_f32, device=dev)
    eps = torch.tensor(1e-8, dtype=_f32, device=dev)
    r0 = T.cross(front, wu.expand_as(front))
    r0 = r0 / torch.maximum(_norm(r0), eps)[..., None]
    u0 = T.cross(r0, front)
    u0 = u0 / torch.maximum(_norm(u0), eps)[..., None]
    cr, sr = cos(roll)[..., None], sin(roll)[..., None]
    right = cr * r0 + sr * u0
    up = -sr * r0 + cr * u0
    top_left = pos + (-right) + up  # screen_w/2 = screen_h/2 = 1 (square)
    return Camera(pos, front, right, up, top_left)


def _golden_gray(golden_path: str, algorithm: Algorithm,
                 res: Tuple[int, int]) -> np.ndarray:
    """Golden PNG -> canonical-frame grayscale [w, h] at resolution ``res``
    (integer-factor area downsample)."""
    disp = load_png(golden_path)
    img = from_display(disp, algorithm)  # [W, H, 3]
    g = img.mean(axis=-1)
    w, h = res
    fw, fh = g.shape[0] // w, g.shape[1] // h
    if fw > 1 or fh > 1:
        g = g[: w * fw, : h * fh].reshape(w, fw, h, fh).mean(axis=(1, 3))
    return g.astype(np.float32)


def _make_score_fn(volume: Volume, tf: TransferFunction,
                   config: RenderConfig, golden_gray: np.ndarray):
    """NCC(render(cam), golden) on the volume's device: Camera -> a 0-d
    tensor there.  The route (``mode="auto"``) is resolved once here, so
    each candidate is one launch of the kernel that renders the config."""
    from ..models.raycast import fast_refusal, render, resolve_mode

    dev = volume.data.device
    mode = resolve_mode("auto", lambda: fast_refusal(volume, tf, config),
                        "camera recovery")
    gc = torch.as_tensor(golden_gray - golden_gray.mean(), dtype=_f32,
                         device=dev)
    g_ss = torch.sum(gc * gc)

    def score(cam: Camera) -> torch.Tensor:
        img = render(volume, tf, cam, config, mode=mode, device=dev)
        r = img[..., :3].mean(dim=-1)
        rc = r - r.mean()
        denom = torch.sqrt(torch.sum(rc * rc) * g_ss) + 1e-12
        return torch.sum(rc * gc) / denom

    return score


def fibonacci_directions(n: int) -> np.ndarray:
    """[n, 2] (theta, phi) roughly uniform on the sphere."""
    i = np.arange(n, dtype=np.float64) + 0.5
    theta = np.arccos(1.0 - 2.0 * i / n)
    phi = (math.pi * (1.0 + 5.0**0.5)) * i
    return np.stack([theta, phi % (2 * math.pi)], axis=-1).astype(np.float32)


def recover_camera(
    golden_path: str,
    volume: Volume,
    tf: TransferFunction,
    *,
    n_dirs: int = 1500,
    n_rolls: int = 12,
    search_res: int = 100,
    refine_res: Optional[int] = None,
    refine_rounds: int = 3,
    view_angles: Optional[list] = None,
    verbose: bool = True,
    device=None,
) -> Dict:
    """Search the orbit manifold for the golden's capture camera, rendering
    on ``device`` (CUDA unless given).

    ``view_angles``: optional list of view_angle values (radians) to also
    search over (view_angle, utils.h:54, sets the ortho screen width, i.e.
    the apparent head size).

    Returns {"golden": name, "angles": [theta, phi, roll], "ncc_search": s,
    "ncc_refined": s2, "refine_res": r, "view_angle": va, "camera": {...}}.
    """
    meta = gold.parse_golden_name(golden_path)
    if meta is None:
        raise ValueError(f"not a golden name: {golden_path}")
    dev = resolve_device(device)
    volume, tf = volume.to(dev), tf.to(dev)
    algorithm = ALGO_BY_ID[meta["algorithm"]]
    native = (meta["width"], meta["height"])
    gg = _golden_gray(golden_path, algorithm, (search_res, search_res))

    dirs = fibonacci_directions(n_dirs)
    rolls = np.linspace(0.0, 2 * math.pi, n_rolls, endpoint=False,
                        dtype=np.float32)
    cand = np.concatenate(
        [
            np.repeat(dirs, n_rolls, axis=0),
            np.tile(rolls, n_dirs)[:, None],
        ],
        axis=-1,
    )  # [n_dirs * n_rolls, 3]

    best, angles, best_va = -2.0, None, None
    for va in (view_angles or [math.pi / 4]):
        cfg_search = RenderConfig(
            width=search_res, height=search_res,
            samples_per_ray=meta["spr"], algorithm=algorithm,
            early_termination=1e-3, view_angle=va,
        )
        score = _make_score_fn(volume, tf, cfg_search, gg)
        scores = []
        for i in range(0, len(cand), CHUNK):
            a = torch.as_tensor(cand[i:i + CHUNK], device=dev)
            cams = angles_to_camera(a[:, 0], a[:, 1], a[:, 2])
            chunk = torch.stack([
                score(Camera(cams.position[j], cams.front[j], cams.right[j],
                             cams.up[j], cams.top_left[j]))
                for j in range(a.shape[0])])
            scores.append(chunk.cpu().numpy())
            if verbose and (i // CHUNK) % 8 == 0:
                b = float(np.concatenate(scores).max())
                print(f"  va={va:.3f} coarse {i + a.shape[0]}/{len(cand)} "
                      f"best NCC {b:.4f}", flush=True)
        scores = np.concatenate(scores)
        bi = int(np.argmax(scores))
        if float(scores[bi]) > best:
            best = float(scores[bi])
            angles = cand[bi].astype(np.float64)
            best_va = va
        if verbose:
            print(f"  va={va:.3f} best NCC {float(scores[bi]):.4f}",
                  flush=True)
    ncc_coarse = best
    if verbose:
        print(f"  coarse best NCC {best:.4f} at angles {angles} "
              f"va {best_va:.3f}", flush=True)

    # --- coordinate-descent refinement at (near-)native resolution -------
    refine_res = refine_res or min(native[0], 350)
    # keep integer downsample factors for the golden
    while native[0] % refine_res:
        refine_res -= 1
    cfg_ref = RenderConfig(
        width=refine_res, height=refine_res, samples_per_ray=meta["spr"],
        algorithm=algorithm, early_termination=1e-3, view_angle=best_va,
    )
    gg_ref = _golden_gray(golden_path, algorithm, (refine_res, refine_res))
    score_ref = _make_score_fn(volume, tf, cfg_ref, gg_ref)

    def score_at(a) -> float:
        a = np.asarray(a, np.float32)
        return float(score_ref(angles_to_camera(*a, device=dev)))

    best = score_at(angles)
    step = np.array([0.05, 0.05, 0.05])
    for r in range(refine_rounds):
        for _ in range(8):
            improved = False
            for k in range(3):
                for sgn in (1.0, -1.0):
                    trial = angles.copy()
                    trial[k] += sgn * step[k]
                    s = score_at(trial)
                    if s > best:
                        best, angles, improved = s, trial, True
            if not improved:
                break
        step /= 4.0
        if verbose:
            print(f"  refine round {r}: NCC {best:.4f}", flush=True)

    cam = angles_to_camera(*np.asarray(angles, np.float32), device=dev)
    return {
        "golden": os.path.basename(golden_path),
        "angles": [float(a) for a in angles],
        "ncc_search": ncc_coarse,
        "ncc_refined": best,
        "refine_res": refine_res,
        "view_angle": float(best_va),
        "camera": {
            k: getattr(cam, k).cpu().tolist()
            for k in ("position", "front", "right", "up", "top_left")
        },
    }


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("goldens", nargs="*",
                    default=None, help="golden PNGs (default: all a1/a5 "
                    "captures in --golden-dir)")
    ap.add_argument("--golden-dir", default="image_output",
                    help="the reference app's capture directory")
    ap.add_argument("--dataset", default="avg152T1_LR_nifti2.nii",
                    help="the NIfTI volume the captures show")
    ap.add_argument("--out", default="goldens/recovered_cameras.json")
    ap.add_argument("--n-dirs", type=int, default=1500)
    ap.add_argument("--n-rolls", type=int, default=12)
    ap.add_argument("--device", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from ..ingest.nifti import load_nifti
    from ..scene.transfer_function import default_transfer_function

    dev = resolve_device(args.device)
    volume = load_nifti(args.dataset, device=dev)
    tf = default_transfer_function(dev)
    paths = args.goldens or sorted(
        os.path.join(args.golden_dir, f)
        for f in os.listdir(args.golden_dir)
        if (m := gold.parse_golden_name(f)) and m["algorithm"] in (1, 5)
    )
    out: Dict[str, Dict] = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)
    for p in paths:
        print(f"recovering {os.path.basename(p)} ...", flush=True)
        rec = recover_camera(p, volume, tf, n_dirs=args.n_dirs,
                             n_rolls=args.n_rolls, device=dev)
        out[rec["golden"]] = rec
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"  -> NCC {rec['ncc_refined']:.4f} (saved)", flush=True)


if __name__ == "__main__":
    main()
