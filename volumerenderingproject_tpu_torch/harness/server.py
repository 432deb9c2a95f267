"""Minimal HTTP render service: the serving counterpart of the reference's
interactive GL viewer (myApp.cu renderLoop + processInput).

The reference explores a volume interactively (WASD orbit, algorithm keys,
O to capture a PNG); this service exposes the same loop statelessly so any
client can drive it:

  GET  /                  -> interactive viewer page (harness/viewer.py)
  GET  /health            -> {"status": "ok", "volume": [...], ...}
  GET  /render?...        -> image/png
  POST /render (JSON)     -> image/png

Query/JSON parameters mirror the CLI: width, height, spr, algorithm
(point|vrc|test), camera ("preset" | "default" | "x,y,z"), orbit
("yaw_deg,pitch_deg,zoom"), lighting (0/1), conic (0/1), scattering (0/1),
depth (0/1: the depth map).  A bad parameter answers 400, an unknown path
404, as the JAX package's server does (``volumerenderingproject_tpu/
harness/server.py``).

The volume and transfer function are loaded once, on the service's device
(CUDA unless ``--device`` names another); each frame goes through
``render()`` (``mode="auto"``: K1 for a1, K3 for a5) and is encoded with the
package's own PNG writer.  ``ThreadingHTTPServer`` answers each request in
a thread of its own, so renders, the start-up warm-up frame included, run
one at a time under the service's lock.

Run: ``python -m volumerenderingproject_tpu_torch.harness.server --data
x.nii --port 8040 [--device cpu]``.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class RenderService:
    """Holds the scene and renders frames on demand (thread-safe)."""

    def __init__(self, volume, tf, device=None):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.volume = volume.to(self.device)
        self.tf = tf.to(self.device)
        self._lock = threading.Lock()

    @staticmethod
    def from_path(data_path: str, device=None) -> "RenderService":
        """``sphere``, ``corner-sphere`` or a NIfTI path, with the default
        transfer function, on ``device`` (CUDA unless given)."""
        from ..ingest import load_nifti, synthetic
        from ..scene.transfer_function import default_transfer_function
        from ..utils.device import resolve_device

        dev = resolve_device(device)
        if data_path == "sphere":
            volume = synthetic.centered_sphere(device=dev)
        elif data_path == "corner-sphere":
            volume = synthetic.corner_sphere(device=dev)
        else:
            volume = load_nifti(data_path, device=dev)
        return RenderService(volume, default_transfer_function(dev), dev)

    def info(self) -> dict:
        return {
            "status": "ok",
            "volume": list(self.volume.dims),
            "channels": self.volume.channels,
            "cal_max": float(self.volume.cal_max),
        }

    def render_png(self, params: dict) -> bytes:
        """PNG bytes (8-bit RGB, display orientation) of a request."""
        from ..models import point_splat
        from ..models.raycast import render
        from ..scene.camera import Camera, default_camera, reset_preset
        from ..utils import imageio
        from ..utils.config import Algorithm, RenderConfig

        dev = self.device
        alg = str(params.get("algorithm", "vrc")).upper()
        config = RenderConfig(
            width=int(params.get("width", 300)),
            height=int(params.get("height", 300)),
            samples_per_ray=int(params.get("spr", 300)),
            algorithm=Algorithm[alg],
            lighting=bool(int(params.get("lighting", 0))),
            scattering=bool(int(params.get("scattering", 0))),
            conic=bool(int(params.get("conic", 0))),
        )
        cam_spec = str(params.get("camera", "preset"))
        if cam_spec == "preset":
            cam = reset_preset(dev)
        elif cam_spec == "default":
            cam = default_camera(dev)
        else:
            pos = tuple(float(v) for v in cam_spec.split(","))
            cam = Camera.initial(
                position=pos,
                screen_w=config.real_screen_width,
                screen_h=config.real_screen_height,
                device=dev,
            )
        if "orbit" in params:
            yaw, pitch, zoom = (float(v) for v in str(params["orbit"]).split(","))
            cam = cam.orbit(
                math.radians(yaw),
                math.radians(pitch),
                zoom,
                screen_w=config.real_screen_width,
                screen_h=config.real_screen_height,
            )

        depth = bool(int(params.get("depth", 0)))
        with self._lock:
            if depth:
                # z-buffer visualization (3.3.zbuffershader.fs analog)
                if config.algorithm is Algorithm.POINT:
                    img = point_splat.render_points_depth(self.volume, cam,
                                                          config)
                else:
                    img = point_splat.render_depth_vrc(self.volume, self.tf,
                                                       cam, config)
            else:
                img = render(self.volume, self.tf, cam, config, device=dev)
            img = img.cpu()

        disp = imageio.to_uint8(imageio.to_display(img, config.algorithm))
        return imageio.encode_png(disp[..., :3])


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str):
            self._send(
                code,
                json.dumps({"error": message}).encode(),
                "application/json",
            )

        def _render(self, params: dict):
            try:
                png = service.render_png(params)
            except (KeyError, ValueError) as e:
                self._error(400, f"bad request: {e}")
                return
            self._send(200, png, "image/png")

        def do_GET(self):
            url = urlparse(self.path)
            if url.path in ("/", "/viewer"):
                from .viewer import VIEWER_HTML

                self._send(200, VIEWER_HTML.encode(), "text/html")
                return
            if url.path == "/health":
                self._send(
                    200, json.dumps(service.info()).encode(), "application/json"
                )
                return
            if url.path == "/render":
                self._render({k: v[0] for k, v in parse_qs(url.query).items()})
                return
            self._error(404, f"unknown path {url.path}")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/render":
                self._error(404, f"unknown path {url.path}")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                params = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._error(400, f"bad json: {e}")
                return
            self._render(params)

    return Handler


def serve(
    data_path: str,
    port: int = 8040,
    host: str = "127.0.0.1",
    warmup: bool = False,
    device=None,
) -> ThreadingHTTPServer:
    """Start the server (returns it; call serve_forever / shutdown).

    ``warmup=True`` renders one default frame in a background thread, under
    the service's lock like any request, so the first interactive request
    does not pay the kernels' build at first use."""
    service = RenderService.from_path(data_path, device)
    if warmup:
        threading.Thread(
            target=lambda: service.render_png({}), daemon=True
        ).start()
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="sphere")
    p.add_argument("--port", type=int, default=8040)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--device", help="torch device (default: cuda)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the background render of the default frame")
    args = p.parse_args(argv)
    httpd = serve(args.data, args.port, args.host, warmup=not args.no_warmup,
                  device=args.device)
    print(f"serving {args.data} on http://{args.host}:{args.port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
