"""The orbit traffic: one viewer stepping the camera round the volume, a
closed loop.  Each frame goes through ``models.raycast.render(mode="auto")``
at the next camera of the orbit (bench.py:116-135, the angle stepping by
the traffic's ``step_degrees`` from a seeded start); its image is copied
into pinned host memory allocated at set-up, and the loop waits for the
copy before the next camera.

The answers checked are the frames of ``check_frames`` cameras of the
orbit's cycle, drawn from the seed: each such camera's last frame lands in
a host buffer of its own.  Once the window has closed, the benchmark's
reference renders each of those cameras, and the widest and the mean gap
of the frame's pixels from the reference's are compared with the cell's
limits.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from gpubench import scene
from gpubench.counts import kernels
from gpubench.reference import a1 as ref


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.tr = cell.traffic
        self.render_spec = cell.config["render"]
        self.fr = ref.Frame.of(self.render_spec)
        rng = np.random.default_rng([self.seed, 1])
        step = math.radians(self.tr["step_degrees"])
        self.n_slots = round(2.0 * math.pi / step)
        theta0 = float(rng.uniform(0.0, step))
        self.views = np.stack([
            scene.orbit_view(theta0 + k * step, self.tr["radius"],
                             self.tr["y0"], self.tr["y_amp"])
            for k in range(self.n_slots)])
        self.checked = sorted(int(k) for k in rng.choice(
            self.n_slots, size=self.tr["check_frames"], replace=False))
        self.frame = 0  # orbit position of the next frame
        self.times: list = []
        self.traced_slots: list = []
        self.seen = dict.fromkeys(self.checked, 0)
        # seconds of set-up spent in the benchmark's reference: none here
        self.reference_s = 0.0

    # -- inputs, made alike for the program and the reference --------------
    def _inputs(self):
        vol = self.cell.config["volume"]
        data = scene.volume(vol, self.seed, self.device)
        tf = scene.transfer_function(self.cell.config["transfer_function"],
                                     self.device)
        light = (scene.light(self.cell.config["light"], self.device)
                 if self.fr.lighting else None)
        views = torch.tensor(self.views, device=self.device)
        return data, tf, light, views

    # -- the program ---------------------------------------------------------
    def setup(self) -> None:
        import volumerenderingproject_tpu_torch as P
        from volumerenderingproject_tpu_torch.ops.phong import Light

        data, tf, light, views = self._inputs()
        dev = self.device
        spec = self.cell.config["volume"]
        self.P = P
        self.volume = P.Volume(
            data=data, cal_max=torch.tensor(float(spec["cal_max"]), device=dev),
            cal_min=torch.tensor(0.0, device=dev),
            pixdim=torch.ones(3, device=dev), dims=tuple(data.shape))
        self.tf = P.TransferFunction(**tf)
        self.light = None if light is None else Light(**light)
        self.config = P.RenderConfig(**self.render_spec)
        self.cams = [P.Camera(*views[k].unbind(0)) for k in range(self.n_slots)]
        w, h = self.fr.width, self.fr.height
        slots = len(self.checked) + 1  # one per checked camera, one scratch
        self.host = torch.empty((slots, w, h, 4), dtype=torch.float32,
                                pin_memory=dev.type == "cuda")
        self.buf = {k: i for i, k in enumerate(self.checked)}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(self.tr["warmup_frames"]):
            self._frame()
        self.times.clear()

    def _frame(self, label: bool = False) -> None:
        slot = self.frame % self.n_slots
        t0 = time.perf_counter()
        if label:
            with torch.profiler.record_function("gpubench.render"):
                img = self._render(slot)
            with torch.profiler.record_function("gpubench.copy"):
                self.host[self.buf.get(slot, -1)].copy_(img, non_blocking=True)
                _sync(self.device)
            self.traced_slots.append(slot)
        else:
            img = self._render(slot)
            self.host[self.buf.get(slot, -1)].copy_(img, non_blocking=True)
            _sync(self.device)
        self.times.append(time.perf_counter() - t0)
        if slot in self.seen:
            self.seen[slot] += 1
        self.frame += 1

    def _render(self, slot: int) -> torch.Tensor:
        return self.P.render(self.volume, self.tf, self.cams[slot],
                             self.config, mode="auto", device=self.device,
                             light=self.light)

    def window(self, seconds: float) -> dict:
        self.times = []
        ends = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._frame()
            ends.append((time.perf_counter() - t0, 1))
        window_s = time.perf_counter() - t0
        n = len(self.times)
        ms = [t * 1e3 for t in self.times]
        rays = self.fr.width * self.fr.height
        metrics = dict(rays_per_s=rays * n / window_s)
        if n >= 2:
            metrics["frame_ms_p95"] = statistics.quantiles(ms, n=100)[94]
        return dict(attempted=n, window_s=window_s, metrics=metrics,
                    unit_ms=ms, unit_ends=ends,
                    traced_units=self.tr["trace_frames"])

    def traced_window(self) -> None:
        for _ in range(self.tr["trace_frames"]):
            self._frame(label=True)

    def release(self) -> None:
        self.volume = self.tf = self.cams = self.light = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------
    def reference_scene(self):
        data, tf, light, views = self._inputs()
        sc = ref.Scene.of(data, self.cell.config["volume"]["cal_max"],
                          tf["lower"], tf["upper"], self.fr.lighting)
        return sc, tf["colors"], (None if light is None else ref.Light(
            **light)), views

    def reference_answers(self, dtype=torch.float32) -> dict:
        """{camera: image [W, H, 4]} of the reference in ``dtype`` (the
        control, where that is below float32)."""
        sc, colors, light, views = self.reference_scene()
        eps = float(self.render_spec.get("early_termination", 0.0))
        out = {}
        for k in self.checked:
            img, _ = ref.render(sc, self.fr, ref.View(*views[k].unbind(0)),
                                colors, light, eps, dtype)
            out[k] = torch.cat([img, torch.ones_like(img[..., :1])], -1)
        return out

    def control_answers(self) -> dict:
        """The control's answers: the reference in bfloat16."""
        return self.reference_answers(torch.bfloat16)

    def answers(self) -> dict:
        """{camera: the program's last frame there} (None where the window
        rendered none)."""
        return {k: (self.host[self.buf[k]].to(self.device)
                    if self.seen[k] else None) for k in self.checked}

    def check(self, answers=None):
        """-> (compared {name: {value, limit}}, frames wrong or missing,
        the work of K1's traced launches)."""
        answers = self.answers() if answers is None else answers
        sc, colors, light, views = self.reference_scene()
        eps = float(self.render_spec.get("early_termination", 0.0))
        widest = mean = 0.0
        failed = 0
        needed = {}
        limits = self.cell.limits
        for k in self.checked:
            want, needed[k] = ref.render(sc, self.fr,
                                         ref.View(*views[k].unbind(0)),
                                         colors, light, eps)
            got = answers.get(k)
            if got is None:
                widest = mean = math.inf
                failed += 1
                continue
            gap = (got[..., :3] - want).abs()
            gap = torch.cat([gap, (got[..., 3:] - 1.0).abs()], -1)
            g_max, g_mean = float(gap.max()), float(gap.mean())
            if not (math.isfinite(g_max) and math.isfinite(g_mean)):
                g_max = g_mean = math.inf
            widest, mean = max(widest, g_max), max(mean, g_mean)
            if (g_max > limits["frame_gap_max"]
                    or g_mean > limits["frame_gap_mean"]):
                failed += 1
        compared = dict(
            frame_gap_max=dict(value=widest, limit=limits["frame_gap_max"]),
            frame_gap_mean=dict(value=mean, limit=limits["frame_gap_mean"]))
        rays = self.fr.width * self.fr.height
        k_intervals = int(colors.shape[0])
        work = {"K1": [
            kernels.k1_work(needed[s], rays, tuple(sc.data.shape),
                            k_intervals, self.fr.lighting)
            if s in needed else None for s in self.traced_slots]}
        return compared, failed, work
