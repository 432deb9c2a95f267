"""Command-line harness of the port.

  render   one frame to PNG
  fit      fit TF colours and density (``--fit-bounds``: and the interval
           bounds, in smooth mode ``--interp trilinear``; ``--fit-light``:
           and the light's 10 parameters, from the default light) to a
           target PNG; lit (``--lighting``), LUT (``--config``) and
           scattered (``--scattering``) renders fit too, and a 4-D volume's
           alpha column

``--mode fast`` (the default) runs the CUDA kernels; ``--mode scan`` the
plain scans, which render and fit every config (``fit``'s self-target is
rendered in the same mode).

Run as ``python -m volumerenderingproject_tpu_torch render ...``.  Each
subcommand runs on CUDA unless ``--device cpu`` is given.  ``--data`` takes
a 3-D or 4-D (multichannel) NIfTI file; ``--conic`` casts perspective
rays.  ``render --mesh rays=2,samples=2`` renders sharded over a (rays,
samples, volume) mesh of that many processes on this host
(``parallel/launch.py``), joined by ``--backend`` nccl (one GPU a rank, the
default) or gloo (ranks may share a GPU, or run on the CPU); rank 0 writes
the PNG.
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
    from ..utils.config import Algorithm, Interp, RenderConfig

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
    if args.lighting:
        over["lighting"] = True
    if args.gradient_filter:
        over["gradient_filter"] = args.gradient_filter
    if args.presmooth:
        over["presmooth_sigma"] = args.presmooth
    if args.conic:
        over["conic"] = True
    if args.interp:
        over["interp"] = Interp(args.interp)
    if args.scattering:
        over["scattering"] = True
    if args.scattering_strength is not None:
        over["scattering_strength"] = args.scattering_strength
    return cfg.replace(**over)


def _tf(args, device):
    from ..scene.transfer_function import default_transfer_function, from_text

    if args.tf:
        with open(args.tf) as f:
            return from_text(f.read(), device)
    return default_transfer_function(device)


def parse_mesh(spec: str, backend: str) -> dict:
    """``rays=2,samples=2`` -> the sizes of ``parallel.mesh.make_mesh``;
    ``rays`` defaults to the GPUs left under nccl, else to 1."""
    sizes = {"samples": 1, "volume": 1}
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        if k not in ("rays", "samples", "volume") or not v.isdigit():
            raise ValueError(f"--mesh {spec!r}: want e.g. rays=2,samples=2")
        sizes[k] = int(v)
    if "rays" not in sizes:
        import torch

        rest = sizes["samples"] * sizes["volume"]
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sizes["rays"] = max(gpus // rest, 1) if backend == "nccl" else 1
    return sizes


def render_rank(rank: int, args) -> None:
    """One rank of ``render --mesh`` (``parallel/launch.cli_render_worker``):
    the scene on this rank's device, the sharded frame; rank 0 writes the
    PNG."""
    import torch

    from ..parallel.launch import rank_device
    from ..parallel.mesh import make_mesh
    from ..parallel.render_dist import render_vrc_sharded
    from ..utils import imageio

    device = rank_device(rank, args.backend, args.device)
    cfg = _config(args)
    volume = _load_volume(args, device)
    tf = _tf(args, device)
    cam = _camera(args, cfg, device)
    mesh = make_mesh(**parse_mesh(args.mesh, args.backend))
    t0 = time.time()
    img = render_vrc_sharded(volume, tf, cam, cfg, mesh, mode=args.mode)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if rank == 0:
        out = _out_name(args, cfg)
        imageio.save_png(out, img, cfg.algorithm)
        print(f"rendered {cfg.width}x{cfg.height} spr={cfg.samples_per_ray} "
              f"alg={cfg.algorithm.name} on mesh {mesh.shape} "
              f"({args.backend}, rank 0 on {device}) in {dt:.2f}s -> {out}")


def _out_name(args, cfg) -> str:
    return args.out or (
        f"image_{cfg.width}x{cfg.height}_a{cfg.algorithm.value}"
        f"_spr{cfg.samples_per_ray}.png"
    )  # reference naming, myApp.cu:1209-1210


def cmd_render(args) -> int:
    import torch

    from ..models.raycast import render
    from ..utils import imageio
    from ..utils.device import resolve_device

    if args.mesh:
        from ..parallel import launch

        sizes = parse_mesh(args.mesh, args.backend)
        world = sizes["rays"] * sizes["samples"] * sizes["volume"]
        launch.check_devices(world, args.backend, args.device)
        launch.spawn(launch.cli_render_worker, world, args.backend, args)
        return 0
    device = resolve_device(args.device)
    cfg = _config(args)
    volume = _load_volume(args, device)
    tf = _tf(args, device)
    cam = _camera(args, cfg, device)
    t0 = time.time()
    img = render(volume, tf, cam, cfg, mode=args.mode, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    out = _out_name(args, cfg)
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

    from ..ops import phong
    from ..ops.march_vjp import check_light_fit_supported

    device = resolve_device(args.device)
    cfg = _config(args)
    volume = _load_volume(args, device)
    tf = _tf(args, device)
    cam = _camera(args, cfg, device)
    light = phong.default_light(device) if args.fit_light else None
    if light is not None and args.mode == "fast":  # before the target's
        check_light_fit_supported(cfg, volume.channels, tf.num_intervals,
                                  light)
    if args.target:
        target = imageio.from_display(imageio.load_png(args.target),
                                      cfg.algorithm)
        if target.shape[:2] != (cfg.width, cfg.height):
            raise ValueError(f"target is {target.shape[0]}x{target.shape[1]} "
                             f"pixels, the render {cfg.width}x{cfg.height}")
        target = torch.as_tensor(np.concatenate(
            [target, np.ones_like(target[..., :1])], -1), device=device)
    else:  # self-target smoke: fit against the render of the start TF
        target = render(volume, tf, cam, cfg, mode=args.mode, device=device)
    t0 = time.time()
    params, losses = fit_transfer_function(
        volume, cam, target, tf, cfg, steps=args.steps,
        learning_rate=args.lr, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, fit_bounds=args.fit_bounds,
        light=light, device=device, mode=args.mode)
    dt = time.time() - t0
    print(f"fit: loss {losses[0]:.6f} -> {losses[-1]:.6f} in {args.steps} "
          f"steps on {device} in {dt:.2f}s")
    if params.light is not None:
        vec = phong.light_to_vec(params.light).detach().cpu().tolist()
        print("fitted light:", [round(v, 4) for v in vec])
    if args.out_tf:
        fitted = TransferFunction(
            tf.lower if params.tf_lower is None else params.tf_lower.detach(),
            tf.upper if params.tf_upper is None else params.tf_upper.detach(),
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
    sp.add_argument("--interp", choices=["nearest", "trilinear_color",
                                         "trilinear"],
                    help="a1 sampling: nearest (the default), trilinear "
                         "(smooth mode) or trilinear_color (a5's colour mix "
                         "on the a1 rays; --mode scan only, as no kernel "
                         "samples it)")
    sp.add_argument("--lighting", action="store_true",
                    help="Phong gradient shading with the default light")
    sp.add_argument("--gradient-filter", choices=["central", "sobel"])
    sp.add_argument("--presmooth", type=float,
                    help="Gaussian sigma for the pre-render gradient filter")
    sp.add_argument("--conic", action="store_true",
                    help="perspective (conic) rays from the camera position")
    sp.add_argument("--scattering", action="store_true",
                    help="single scattering of the default light (HG phase "
                         "x light transmittance)")
    sp.add_argument("--scattering-strength", type=float)
    sp.add_argument("--mode", choices=["fast", "scan"], default="fast",
                    help="fast: the CUDA kernels (the default); scan: the "
                         "plain scans, which render and fit every config")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="volumerenderingproject_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("render", help="render one frame to PNG")
    _common(sp)
    sp.add_argument("--out")
    sp.add_argument("--mesh", help="render sharded over a (rays, samples, "
                    "volume) mesh of processes, e.g. rays=2,samples=2")
    sp.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="the process group of --mesh: nccl (one GPU a "
                         "rank) or gloo (ranks may share a GPU or run on "
                         "the CPU)")
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
                    help="optimize TF interval bounds too (smooth mode: "
                         "--interp trilinear)")
    sp.add_argument("--fit-light", action="store_true",
                    help="optimize the light parameters too, from the "
                         "default light (a1, ortho, no LUT)")
    sp.set_defaults(fn=cmd_fit)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
