"""Port parity of the render service (``harness/server.py``) and its viewer
page (``harness/viewer.py``): ``RenderService.render_png`` on the CPU
against the JAX package's, both PNGs decoded; the HTTP routes and their
answers; every render, the warm-up included, one at a time under the
service's lock."""

import io
import json
import re
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from volumerenderingproject_tpu.harness import server as jserver
from volumerenderingproject_tpu.harness.viewer import VIEWER_HTML as JHTML

from volumerenderingproject_tpu_torch.harness import server
from volumerenderingproject_tpu_torch.harness.viewer import VIEWER_HTML
from volumerenderingproject_tpu_torch.models import raycast
from volumerenderingproject_tpu_torch.utils import imageio

SIZE = {"width": 16, "height": 16, "spr": 8}
LSB = 1  # PNG levels the port's pixels may stand from the JAX package's


@pytest.fixture(scope="module")
def services():
    return (jserver.RenderService.from_path("sphere"),
            server.RenderService.from_path("sphere", device="cpu"))


@pytest.mark.parametrize("extra", [
    {}, {"algorithm": "test"}, {"algorithm": "point"}, {"depth": 1},
    {"depth": 1, "algorithm": "point"}, {"orbit": "30,-20,0.1"},
    {"lighting": 1}, {"conic": 1}, {"scattering": 1},
    {"camera": "default", "spr": 40},
], ids=["vrc", "test", "point", "depth", "point_depth", "orbit", "lighting",
        "conic", "scattering", "default_camera"])
def test_render_png_matches_jax(services, extra):
    jsvc, svc = services
    params = dict(SIZE, **extra)
    want = np.asarray(Image.open(io.BytesIO(jsvc.render_png(params))),
                      np.int32)
    got = imageio.decode_png(svc.render_png(params)).astype(np.int32)
    assert got.shape == want.shape == (16, 16, 3)
    differ = int((got != want).any(-1).sum())
    print(f"{extra}: {differ} of 256 pixels differ from the JAX PNG")
    assert np.abs(got - want).max() <= LSB


@pytest.fixture(scope="module")
def running_server():
    httpd = server.serve("sphere", port=0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _post(url, body: bytes):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_health(running_server):
    code, ctype, body = _get(running_server + "/health")
    assert code == 200 and ctype == "application/json"
    assert json.loads(body) == {"status": "ok", "volume": [100, 100, 100],
                                "channels": 1, "cal_max": 255.0}


def test_render_get_and_post(running_server):
    svc = server.RenderService.from_path("sphere", device="cpu")
    code, ctype, body = _get(
        running_server + "/render?width=16&height=12&spr=8&camera=default")
    assert code == 200 and ctype == "image/png"
    assert body == svc.render_png({"width": "16", "height": "12",
                                   "spr": "8", "camera": "default"})
    assert imageio.decode_png(body).shape == (12, 16, 3)
    params = {"width": 12, "height": 10, "spr": 6, "orbit": "45,0,0"}
    code, ctype, body = _post(running_server + "/render",
                              json.dumps(params).encode())
    assert code == 200 and ctype == "image/png"
    assert body == svc.render_png(params)
    assert imageio.decode_png(body).shape == (10, 12, 3)


@pytest.mark.parametrize("method,path,body,code", [
    ("GET", "/render?algorithm=bogus", None, 400),
    ("GET", "/render?width=abc", None, 400),
    ("POST", "/render", b"not json", 400),
    ("POST", "/render", b'{"algorithm": "bogus"}', 400),
    ("GET", "/nope", None, 404),
    ("POST", "/nope", b"{}", 404),
])
def test_bad_requests(running_server, method, path, body, code):
    with pytest.raises(urllib.error.HTTPError) as e:
        if method == "GET":
            _get(running_server + path)
        else:
            _post(running_server + path, body)
    assert e.value.code == code
    assert "error" in json.loads(e.value.read())


def test_viewer_page(running_server):
    code, ctype, body = _get(running_server + "/")
    assert code == 200 and ctype == "text/html"
    assert body.decode() == VIEWER_HTML
    assert "<title>volumerenderingproject_tpu_torch viewer</title>" in VIEWER_HTML


def test_viewer_keys_match_jax():
    """The port's page is the JAX package's with its own title: the same
    key set (1:1 with processInput), each key bound once."""
    keys = re.findall(r'k === "(\w)"', VIEWER_HTML)
    assert len(keys) == len(set(keys))
    assert set(keys) == set(re.findall(r'k === "(\w)"', JHTML))
    assert VIEWER_HTML.replace("volumerenderingproject_tpu_torch viewer",
                               "volumerenderingproject_tpu viewer") == JHTML


def test_renders_run_one_at_a_time_under_the_lock(monkeypatch):
    """The warm-up frame and concurrent requests each render holding the
    service's lock, never two at once."""
    svc = server.RenderService.from_path("sphere", device="cpu")
    monkeypatch.setattr(server.RenderService, "from_path",
                        staticmethod(lambda *a, **k: svc))
    real = raycast.render
    state = {"active": 0, "most": 0, "calls": 0, "unlocked": 0}
    guard = threading.Lock()
    first = threading.Event()

    def render(*args, **kwargs):
        with guard:
            state["active"] += 1
            state["calls"] += 1
            state["most"] = max(state["most"], state["active"])
            state["unlocked"] += not svc._lock.locked()
        first.set()
        time.sleep(0.02)
        try:
            return real(*args, **kwargs)
        finally:
            with guard:
                state["active"] -= 1

    monkeypatch.setattr(raycast, "render", render)
    httpd = server.serve("sphere", port=0, warmup=True, device="cpu")
    try:
        assert first.wait(60), "the warm-up frame did not render"
        params = dict(SIZE)
        with ThreadPoolExecutor(6) as pool:
            pngs = list(pool.map(lambda i: svc.render_png(
                dict(params, orbit=f"{10 * i},0,0")), range(6)))
    finally:
        httpd.server_close()
    deadline = time.time() + 60
    while state["calls"] < 7 and time.time() < deadline:
        time.sleep(0.01)
    assert state["calls"] == 7 and state["unlocked"] == 0
    assert state["most"] == 1
    assert all(imageio.decode_png(p).shape == (16, 16, 3) for p in pngs)
