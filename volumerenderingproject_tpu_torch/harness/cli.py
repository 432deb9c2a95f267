"""Command-line harness of the port.

  render   one frame to PNG (``--depth``: the depth map; ``--exact-points``:
           the point cloud through the native GL rasterizer)
  orbit    a camera-orbit frame sequence (the WASD loop, myApp.cu:1088-1112)
  fit      fit TF colours and density (``--fit-bounds``: and the interval
           bounds, in smooth mode ``--interp trilinear``; ``--fit-light``:
           and the light's 10 parameters, from the default light) to a
           target PNG; lit (``--lighting``), LUT (``--config``) and
           scattered (``--scattering``) renders fit too, and a 4-D volume's
           alpha column
  bench    a timed render with a per-stage report and a rays/s JSON line
           (``--profile DIR``: a torch.profiler Chrome trace of the frames)
  info     dump a NIfTI header (displayNIFTI2Header, BinaryLoader.cu:166)
  compare  score a render against a golden PNG; exit 1 below
           ``--threshold``
  recover-golden
           search the orbit manifold for golden captures' cameras
           (``harness/camera_recovery.py``) and write them as JSON

``--mode auto`` (the default) takes the CUDA kernels where they compute the
config and the plain scans otherwise, and prints the route it took;
``--mode fast`` runs the kernels and raises for the rest; ``--mode scan``
the plain scans, which render and fit every config (``fit``'s self-target
is rendered in the same mode).  ``--algorithm point`` renders the a0
voxel point cloud.  ``--orbit yaw,pitch,zoom`` (degrees) moves the camera
before the first frame; ``render --window WxH`` draws the frame through a
textured fullscreen quad of that many window pixels (``utils/texture.py``).

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
import json
import logging
import math
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
        cam = reset_preset(device)
    elif args.camera == "default":
        cam = default_camera(device)
    else:
        pos = tuple(float(v) for v in args.camera.split(","))
        cam = Camera.initial(position=pos, screen_w=config.real_screen_width,
                             screen_h=config.real_screen_height,
                             device=device)
    if args.orbit:
        yaw, pitch, zoom = (float(v) for v in args.orbit.split(","))
        cam = cam.orbit(math.radians(yaw), math.radians(pitch), zoom,
                        screen_w=config.real_screen_width,
                        screen_h=config.real_screen_height)
    return cam


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


def _render(volume, tf, cam, cfg, args, device):
    """One frame of ``render``, ``orbit`` or ``bench`` -> [W, H, 4]: the
    depth map with ``--depth`` (the point cloud's depth buffer for
    ``--algorithm point``, the ray caster's E[t] otherwise), the native
    point rasterizer with ``--exact-points``, else ``render``."""
    from ..models import point_splat
    from ..models.raycast import render
    from ..utils.config import Algorithm

    point = cfg.algorithm is Algorithm.POINT
    if getattr(args, "depth", False):
        if point:
            return point_splat.render_points_depth(volume, cam, cfg)
        return point_splat.render_depth_vrc(volume, tf, cam, cfg)
    if getattr(args, "exact_points", False) and point:
        return point_splat.render_points(volume, tf, cam, cfg, exact=True)
    return render(volume, tf, cam, cfg, mode=args.mode, device=device)


def _scene(args):
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = _config(args)
    return (device, cfg, _load_volume(args, device), _tf(args, device),
            _camera(args, cfg, device))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
        imageio.save_png(out, _windowed(args, img), cfg.algorithm)
        print(f"rendered {cfg.width}x{cfg.height} spr={cfg.samples_per_ray} "
              f"alg={cfg.algorithm.name} on mesh {mesh.shape} "
              f"({args.backend}, rank 0 on {device}) in {dt:.2f}s -> {out}")


def _windowed(args, img):
    """``render --window WxH``: the frame resampled onto a fullscreen quad
    of that many window pixels (myApp.cu:1732-1901's unfinished
    render-to-texture path, ``utils/texture.py``), or the frame as it is."""
    if not getattr(args, "window", None):
        return img
    from ..utils.texture import texture_quad_display

    ww, wh = (int(x) for x in args.window.split("x"))
    return texture_quad_display(img, ww, wh)


def _out_name(args, cfg) -> str:
    return args.out or (
        f"image_{cfg.width}x{cfg.height}_a{cfg.algorithm.value}"
        f"_spr{cfg.samples_per_ray}.png"
    )  # reference naming, myApp.cu:1209-1210


def cmd_render(args) -> int:
    from ..parallel.render_dist import POINT_MESH_MESSAGE
    from ..utils import imageio
    from ..utils.config import Algorithm

    if args.mesh:
        from ..parallel import launch

        if _config(args).algorithm is Algorithm.POINT:
            raise SystemExit(f"error: {POINT_MESH_MESSAGE}")
        sizes = parse_mesh(args.mesh, args.backend)
        world = sizes["rays"] * sizes["samples"] * sizes["volume"]
        launch.check_devices(world, args.backend, args.device)
        launch.spawn(launch.cli_render_worker, world, args.backend, args)
        return 0
    device, cfg, volume, tf, cam = _scene(args)
    t0 = time.time()
    img = _render(volume, tf, cam, cfg, args, device)
    _sync(device)
    dt = time.time() - t0
    out = _out_name(args, cfg)
    imageio.save_png(out, _windowed(args, img), cfg.algorithm)
    print(f"rendered {cfg.width}x{cfg.height} spr={cfg.samples_per_ray} "
          f"alg={cfg.algorithm.name} on {device} in {dt:.2f}s -> {out}")
    return 0


def cmd_orbit(args) -> int:
    """``--frames`` frames, the camera turned ``--step-deg`` degrees of yaw
    between them, to ``<out-prefix>0000.png``, ..."""
    from ..utils import imageio

    device, cfg, volume, tf, cam = _scene(args)
    step = math.radians(args.step_deg)
    for i in range(args.frames):
        img = _render(volume, tf, cam, cfg, args, device)
        path = f"{args.out_prefix}{i:04d}.png"
        imageio.save_png(path, img, cfg.algorithm)
        print(f"frame {i}: {path}")
        cam = cam.orbit(yaw_rad=step, screen_w=cfg.real_screen_width,
                        screen_h=cfg.real_screen_height)
    return 0


def cmd_bench(args) -> int:
    """The first frame, then ``--repeats`` frames of cameras 1e-6 apart,
    each a stage of :class:`profiling.StageTimer` (the device synchronized
    around it); the report and ``{"metric": "rays_per_sec_WxH_sprN",
    ...}`` of the best frame.  ``--profile DIR`` traces the timed frames
    (``profiling.trace``)."""
    import contextlib
    import dataclasses

    from .profiling import StageTimer, trace

    device, cfg, volume, tf, cam = _scene(args)
    timer = StageTimer()
    with timer.stage("first") as out:
        out["img"] = _render(volume, tf, cam, cfg, args, device)
    ctx = trace(args.profile) if args.profile else contextlib.nullcontext()
    with ctx:
        for r in range(args.repeats):
            cam_r = dataclasses.replace(cam,
                                        position=cam.position + 1e-6 * (r + 1))
            with timer.stage(f"frame{r}") as out:
                out["img"] = _render(volume, tf, cam_r, cfg, args, device)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(timer.report())
    frames = [t for n, t in timer.stages if n.startswith("frame")]
    if frames:
        print(json.dumps({
            "metric": f"rays_per_sec_{cfg.width}x{cfg.height}"
                      f"_spr{cfg.samples_per_ray}",
            "value": round(cfg.num_rays / min(frames), 1),
            "unit": "rays/s"}))
    return 0


def cmd_info(args) -> int:
    from ..ingest.nifti import parse_header

    with open(args.data, "rb") as f:
        hdr = parse_header(f.read(1024))
    for field in ("sizeof_hdr", "magic", "datatype", "bitpix", "dim",
                  "pixdim", "vox_offset", "scl_slope", "scl_inter",
                  "cal_max", "cal_min", "byteorder"):
        print(f"{field.upper()}: {getattr(hdr, field)}")
    return 0


def cmd_compare(args) -> int:
    from ..utils import imageio
    from . import goldens

    ours = imageio.load_png(args.ours)
    golden = imageio.load_png(args.golden)
    meta = goldens.parse_golden_name(args.golden)
    if meta:
        print(f"golden config: {meta}")
    sim = goldens.similarity(ours, golden)
    print(f"similarity (ncc): {sim:.4f}")
    return 0 if sim >= args.threshold else 1


def cmd_recover_golden(args) -> int:
    from .camera_recovery import main as recover_main

    argv = list(args.goldens)
    argv += ["--golden-dir", args.golden_dir, "--dataset", args.dataset,
             "--out", args.out, "--n-dirs", str(args.n_dirs),
             "--n-rolls", str(args.n_rolls)]
    if args.device:
        argv += ["--device", args.device]
    recover_main(argv)
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
                    help="vrc (a1, the default), test (a5) or point (a0, "
                         "the voxel point cloud)")
    sp.add_argument("--orbit", help="yaw_deg,pitch_deg,zoom: orbit the "
                    "camera before the first frame")
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
    sp.add_argument("--mode", choices=["auto", "fast", "scan"],
                    default="auto",
                    help="auto (the default): the CUDA kernels where they "
                         "compute the config, else the plain scans, the "
                         "route printed; fast: the kernels; scan: the "
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
    sp.add_argument("--depth", action="store_true",
                    help="render the depth map (the z-buffer shader's "
                         "analog) instead of colours")
    sp.add_argument("--exact-points", action="store_true",
                    help="--algorithm point: exact GL draw-order blending "
                         "(the native rasterizer, on the host)")
    sp.add_argument("--window", metavar="WxH",
                    help="display the render through a textured fullscreen "
                         "quad at this window size (render-to-texture)")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("orbit", help="render an orbit sequence")
    _common(sp)
    sp.add_argument("--frames", type=int, default=8)
    sp.add_argument("--step-deg", type=float, default=45.0)
    sp.add_argument("--out-prefix", default="orbit_")
    sp.set_defaults(fn=cmd_orbit)

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

    sp = sub.add_parser("bench", help="timed render with per-stage report")
    _common(sp)
    sp.add_argument("--repeats", type=int, default=3)
    sp.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the timed "
                         "frames to DIR/trace.json")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("info", help="dump a NIfTI header")
    sp.add_argument("--data", required=True)
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("compare", help="compare a render to a golden PNG")
    sp.add_argument("--ours", required=True)
    sp.add_argument("--golden", required=True)
    sp.add_argument("--threshold", type=float, default=0.0)
    sp.set_defaults(fn=cmd_compare)

    sp = sub.add_parser(
        "recover-golden",
        help="search the orbit manifold for a golden capture's camera "
             "(harness/camera_recovery.py)")
    sp.add_argument("goldens", nargs="*")
    sp.add_argument("--golden-dir", default="image_output",
                    help="the reference app's capture directory")
    sp.add_argument("--dataset", default="avg152T1_LR_nifti2.nii",
                    help="the NIfTI volume the captures show")
    sp.add_argument("--out", default="goldens/recovered_cameras.json")
    sp.add_argument("--n-dirs", type=int, default=1500)
    sp.add_argument("--n-rolls", type=int, default=12)
    sp.add_argument("--device", help="torch device (default: cuda)")
    sp.set_defaults(fn=cmd_recover_golden)
    return p


class _RoutePrinter(logging.Handler):
    """Prints ``mode="auto"``'s route (``models/raycast.route_log``)."""

    def emit(self, record: logging.LogRecord) -> None:
        print(f"route: {record.getMessage()}", flush=True)


def main(argv=None) -> int:
    from ..models.raycast import route_log

    args = build_parser().parse_args(argv)
    if not any(isinstance(h, _RoutePrinter) for h in route_log.handlers):
        route_log.addHandler(_RoutePrinter())
    route_log.setLevel(logging.INFO)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
