"""Command-line harness of the port.

  render   one frame to PNG
  fit      fit TF colours and density to a target PNG

Run as ``python -m volumerenderingproject_tpu_torch render ...``.  Each
subcommand runs on CUDA unless ``--device cpu`` is given.
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
    from ..utils.config import Algorithm, RenderConfig

    cfg = RenderConfig()
    if args.config:
        with open(args.config) as f:
            cfg = RenderConfig.from_json(f.read())
    over = {}
    if args.algorithm:
        over["algorithm"] = Algorithm[args.algorithm.upper()]
    if args.width:
        over["width"] = args.width
    if args.height:
        over["height"] = args.height
    if args.spr:
        over["samples_per_ray"] = args.spr
    if getattr(args, "lighting", False):
        over["lighting"] = True
    if getattr(args, "gradient_filter", None):
        over["gradient_filter"] = args.gradient_filter
    if getattr(args, "presmooth", None):
        over["presmooth_sigma"] = args.presmooth
    return cfg.replace(**over)


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


def cmd_fit(args) -> int:
    import numpy as np
    import torch

    from ..diff.fit import fit_transfer_function
    from ..models.raycast import render
    from ..scene.transfer_function import TransferFunction, to_text
    from ..utils import imageio
    from ..utils.device import resolve_device

    if args.fit_bounds:
        raise NotImplementedError(
            "--fit-bounds is not ported yet: ROADMAP.md item 12 (smooth mode)")
    if args.fit_light:
        raise NotImplementedError(
            "--fit-light is not ported yet: ROADMAP.md item 9 (lighting, LUT "
            "and scattering)")
    device = resolve_device(args.device)
    cfg = _config(args)
    volume = _load_volume(args, device)
    tf = _tf(args, device)
    cam = _camera(args, cfg, device)
    if args.target:
        target = imageio.from_display(imageio.load_png(args.target),
                                      cfg.algorithm)
        if target.shape[:2] != (cfg.width, cfg.height):
            raise ValueError(f"target is {target.shape[0]}x{target.shape[1]} "
                             f"pixels, the render {cfg.width}x{cfg.height}")
        target = torch.as_tensor(np.concatenate(
            [target, np.ones_like(target[..., :1])], -1), device=device)
    else:  # self-target smoke: fit against the render of the start TF
        target = render(volume, tf, cam, cfg, device=device)
    t0 = time.time()
    params, losses = fit_transfer_function(
        volume, cam, target, tf, cfg, steps=args.steps,
        learning_rate=args.lr, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, device=device)
    dt = time.time() - t0
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} in {args.steps} "
          f"steps on {device} in {dt:.2f}s")
    if args.out_tf:
        fitted = TransferFunction(tf.lower, tf.upper,
                                  params.tf_colors.detach(), tf.hg_g)
        with open(args.out_tf, "w") as f:
            f.write(to_text(fitted))
        print(f"wrote {args.out_tf}")
    return 0


def _common(sp) -> None:
    sp.add_argument("--data", default="sphere",
                    help=".nii path, or 'sphere' / 'corner-sphere' fixtures")
    sp.add_argument("--width", type=int)
    sp.add_argument("--height", type=int)
    sp.add_argument("--spr", type=int)
    sp.add_argument("--camera", default="preset",
                    help="'preset', 'default', or a position x,y,z")
    sp.add_argument("--tf", help="transfer-function text file")
    sp.add_argument("--algorithm", choices=["point", "vrc", "test"],
                    help="vrc (a1, the default) or test (a5); point is "
                         "not ported yet (the renderer raises)")
    sp.add_argument("--device", help="torch device (default: cuda)")
    sp.add_argument("--config", help="RenderConfig JSON path (the flags "
                    "override its fields; tf_lut is set here)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volumerenderingproject_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("render", help="render one frame to PNG")
    _common(sp)
    sp.add_argument("--out")
    sp.add_argument("--lighting", action="store_true",
                    help="Phong gradient shading with the default light")
    sp.add_argument("--gradient-filter", choices=["central", "sobel"])
    sp.add_argument("--presmooth", type=float,
                    help="Gaussian sigma for the pre-render gradient filter")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("fit", help="optimize TF colors to a target image")
    _common(sp)
    sp.add_argument("--target", help="target PNG (display orientation)")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--out-tf")
    sp.add_argument("--checkpoint-dir")
    sp.add_argument("--checkpoint-every", type=int, default=0)
    sp.add_argument("--fit-bounds", action="store_true",
                    help="optimize TF interval bounds too (not ported yet)")
    sp.add_argument("--fit-light", action="store_true",
                    help="optimize the light parameters (not ported yet)")
    sp.set_defaults(fn=cmd_fit)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
