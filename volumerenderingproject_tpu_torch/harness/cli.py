"""Command-line harness of the port.

  render   one frame to PNG

Run as ``python -m volumerenderingproject_tpu_torch render ...``.  The
render runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time


def _load_volume(args, device):
    from ..ingest import load_nifti, synthetic

    if args.data == "sphere":
        return synthetic.centered_sphere(device=device)
    if args.data == "corner-sphere":
        return synthetic.corner_sphere(device=device)
    return load_nifti(args.data, device=device)


def _camera(args, config, device):
    from ..scene.camera import Camera, default_camera, reset_preset

    if args.camera == "preset":
        return reset_preset(device)
    if args.camera == "default":
        return default_camera(device)
    pos = tuple(float(v) for v in args.camera.split(","))
    return Camera.initial(position=pos, screen_w=config.real_screen_width,
                          screen_h=config.real_screen_height, device=device)


def _config(args):
    from ..utils.config import RenderConfig

    over = {}
    if args.width:
        over["width"] = args.width
    if args.height:
        over["height"] = args.height
    if args.spr:
        over["samples_per_ray"] = args.spr
    return RenderConfig(**over)


def _tf(args, device):
    from ..scene.transfer_function import default_transfer_function, from_text

    if args.tf:
        with open(args.tf) as f:
            return from_text(f.read(), device)
    return default_transfer_function(device)


def cmd_render(args) -> int:
    import torch

    from ..models.raycast import render
    from ..utils import imageio
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _config(args)
    volume = _load_volume(args, device)
    tf = _tf(args, device)
    cam = _camera(args, cfg, device)
    t0 = time.time()
    img = render(volume, tf, cam, cfg, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    out = args.out or (
        f"image_{cfg.width}x{cfg.height}_a{cfg.algorithm.value}"
        f"_spr{cfg.samples_per_ray}.png"
    )  # reference naming, myApp.cu:1209-1210
    imageio.save_png(out, img, cfg.algorithm)
    print(f"rendered {cfg.width}x{cfg.height} spr={cfg.samples_per_ray} "
          f"alg={cfg.algorithm.name} on {device} in {dt:.2f}s -> {out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volumerenderingproject_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("render", help="render one frame to PNG")
    sp.add_argument("--data", default="sphere",
                    help=".nii path, or 'sphere' / 'corner-sphere' fixtures")
    sp.add_argument("--width", type=int)
    sp.add_argument("--height", type=int)
    sp.add_argument("--spr", type=int)
    sp.add_argument("--camera", default="preset",
                    help="'preset', 'default', or a position x,y,z")
    sp.add_argument("--tf", help="transfer-function text file")
    sp.add_argument("--out")
    sp.add_argument("--device", help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_render)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
