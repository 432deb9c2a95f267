"""The fit traffic: one client running fit jobs back to back, a closed loop.
A job is ``steps`` Adam steps of ``diff.fit.fit_transfer_function(mode=
"auto")`` at the traffic's learning rate, its own set-up (route,
``FitParams.init``, optimizer) included, against the target of one of
``cameras`` orbit cameras 90 degrees apart (bench.py:116-135, from a seeded
angle), cycled job by job.  A job starts from the configuration's TF with
the rgb of intervals 1.. moved by a seeded uniform +-``perturb_rgb``, and,
with ``light_start``, from the configuration's light with those fields
changed, which the job fits too.  The targets are the benchmark's
reference renders of the configuration's TF (and light) at eps 0, made at
set-up.

The answers checked are ``check_jobs`` jobs drawn from the seed among those
the window completed: the benchmark's reference runs each job's steps from
its start by autograd and its own Adam.  The numbers: the widest relative
gap of a step's loss, over the job and over its first ``START_STEPS``
steps, and by the worst parameter leaf the gap of the norms of the last
step's gradient and of the parameters' change over the job.  A cell's
limits file names the numbers it compares; the others are printed.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from gpubench import scene
from gpubench.counts import kernels
from gpubench.reference import a1 as ref

LIGHT_FIELDS = scene.LIGHT_FIELDS
# starts drawn at set-up; job j starts from start j mod STARTS
STARTS = 512
# the steps whose losses ``start_loss_gap`` compares: the start's and the
# first two updates', before Adam's steps on gradients near zero can send
# the program and the reference along different paths
START_STEPS = 3
# leaves whose first reference gradient is below this share of the median
# leaf's are left out of the change (they move by Adam's round-off)
STILL_SHARE = 1e-3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(prog: dict, want: dict, skip=()) -> float:
    """The worst leaf's |‖prog‖ - ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖, leaves in ``skip`` left out."""
    names = [k for k in want if k not in skip]
    ref_norms = {k: _norm(want[k]) for k in names}
    median = float(np.median(list(ref_norms.values()))) if names else 0.0
    worst = 0.0
    for k in names:
        den = max(ref_norms[k], median)
        if den <= 0.0:
            continue
        gap = abs(_norm(prog[k]) - ref_norms[k]) / den
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


class Driver:
    def __init__(self, cell, seed: int, device):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.tr = cell.traffic
        self.render_spec = cell.config["render"]
        self.fr = ref.Frame.of(self.render_spec)
        rng = np.random.default_rng([self.seed, 2])
        theta0 = float(rng.uniform(0.0, 2.0 * math.pi))
        n = self.tr["cameras"]
        self.views = np.stack([scene.orbit_view(
            theta0 + 2.0 * math.pi * k / n) for k in range(n)])
        k = len(cell.config["transfer_function"]["lower_255"])
        moves = np.zeros((STARTS, k, 4), np.float32)
        moves[:, 1:, :3] = rng.uniform(
            -self.tr["perturb_rgb"], self.tr["perturb_rgb"], (STARTS, k - 1, 3))
        self.moves = moves
        self.jobs: list = []  # (job index, params, losses)
        self.job = 0
        self.traced_jobs: list = []
        # seconds of set-up spent in the benchmark's reference (the targets)
        self.reference_s = 0.0

    # -- inputs --------------------------------------------------------------
    def _inputs(self):
        data = scene.volume(self.cell.config["volume"], self.seed,
                            self.device)
        tf = scene.transfer_function(self.cell.config["transfer_function"],
                                     self.device)
        views = torch.tensor(self.views, device=self.device)
        return data, tf, views

    def _light(self, start: bool) -> dict | None:
        spec = self.cell.config["light"]
        over = self.tr.get("light_start")
        if not self.fr.lighting:
            return None
        return scene.light(spec, self.device, **(over if start and over
                                                 else {}))

    def start_leaves(self, j: int, colors: torch.Tensor) -> dict:
        """The leaves job ``j`` starts from."""
        leaves = dict(tf_colors=colors + torch.tensor(
            self.moves[j % STARTS], device=self.device),
            density_scale=torch.tensor(1.0, device=self.device))
        if self.tr.get("light_start"):
            leaves.update(self._light(True))
        return leaves

    def reference_scene(self, inputs=None):
        data, tf, views = inputs or self._inputs()
        sc = ref.Scene.of(data, self.cell.config["volume"]["cal_max"],
                          tf["lower"], tf["upper"], self.fr.lighting)
        return sc, tf, views

    # -- the program ---------------------------------------------------------
    def setup_targets(self):
        """The targets: the reference's frames of the configuration's TF
        and light at eps 0, and the samples inside the dataset at each
        camera -> the reference's scene, TF and views.  The seconds after
        the inputs are made go to ``reference_s``."""
        inputs = self._inputs()
        _sync(self.device)
        t0 = time.perf_counter()
        sc, tf, views = self.reference_scene(inputs)
        light = self._light(False)
        self.targets, self.inside = [], []
        for k in range(len(self.views)):
            img, inside = ref.render(sc, self.fr, ref.View(*views[k].unbind(0)),
                                     tf["colors"], None if light is None
                                     else ref.Light(**light), 0.0)
            self.targets.append(torch.cat([img, torch.ones_like(img[..., :1])],
                                          -1))
            self.inside.append(inside)
        _sync(self.device)
        self.reference_s = time.perf_counter() - t0
        return sc, tf, views

    def setup(self) -> None:
        import volumerenderingproject_tpu_torch as P
        from volumerenderingproject_tpu_torch.diff import fit
        from volumerenderingproject_tpu_torch.ops.phong import Light

        dev = self.device
        sc, tf, views = self.setup_targets()
        spec = self.cell.config["volume"]
        self.P, self.fit, self.Light = P, fit, Light
        self.volume = P.Volume(
            data=sc.data, cal_max=torch.tensor(float(spec["cal_max"]),
                                               device=dev),
            cal_min=torch.tensor(0.0, device=dev),
            pixdim=torch.ones(3, device=dev), dims=tuple(sc.data.shape))
        del sc
        self.tf0 = tf
        self.starts = tf["colors"][None] + torch.tensor(self.moves, device=dev)
        ls = self._light(True) if self.tr.get("light_start") else None
        self.light_start = None if ls is None else Light(**ls)
        self.config = P.RenderConfig(**self.render_spec)
        self.cams = [P.Camera(*views[k].unbind(0))
                     for k in range(len(self.views))]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t2 = time.perf_counter()
        for _ in range(self.tr["warmup_jobs"]):
            self._job(keep=False)
        self.jobs.clear()
        print(f"set-up: targets {self.reference_s:.3f} s, warm-up "
              f"{time.perf_counter() - t2:.3f} s", file=sys.stderr)

    def _job(self, keep: bool = True, label: bool = False) -> None:
        j = self.job
        cam = j % len(self.cams)
        tf = self.P.TransferFunction(
            lower=self.tf0["lower"], upper=self.tf0["upper"],
            colors=self.starts[j % STARTS], hg_g=self.tf0["hg_g"])
        if label:
            with torch.profiler.record_function("gpubench.fit_job"):
                params, losses = self._fit(cam, tf)
            self.traced_jobs.append(j)
        else:
            params, losses = self._fit(cam, tf)
        if keep:
            self.jobs.append((j, params, losses))
        self.job += 1

    def _fit(self, cam: int, tf):
        return self.fit.fit_transfer_function(
            self.volume, self.cams[cam], self.targets[cam], tf, self.config,
            steps=self.tr["steps"], learning_rate=self.tr["learning_rate"],
            light=self.light_start, device=self.device, mode="auto")

    def window(self, seconds: float) -> dict:
        self.jobs = []
        ends = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._job()
            ends.append((time.perf_counter() - t0, len(self.jobs[-1][2])))
        _sync(self.device)
        window_s = time.perf_counter() - t0
        steps = sum(len(losses) for _, _, losses in self.jobs)
        return dict(attempted=len(self.jobs), window_s=window_s,
                    unit_ends=ends,
                    metrics=dict(fit_step_ms=window_s / steps * 1e3),
                    traced_units=self.tr["trace_jobs"] * self.tr["steps"])

    def traced_window(self) -> None:
        for _ in range(self.tr["trace_jobs"]):
            self._job(keep=False, label=True)

    def release(self) -> None:
        self.volume = self.cams = self.light_start = self.starts = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------
    def control_answers(self) -> list:
        """The control's answers: the reference in bfloat16 following the
        first ``check_jobs`` jobs, without the program."""
        self.setup_targets()
        self.jobs = [(j, None, None) for j in range(self.tr["check_jobs"])]
        runs = self.reference_jobs(self.sample(), dtype=torch.bfloat16)
        return [(losses, final, grads[-1]) for losses, final, grads in runs]

    @staticmethod
    def _program_leaves(params) -> tuple:
        """({name: value}, {name: gradient}) of a job's returned FitParams."""
        vals = dict(tf_colors=params.tf_colors,
                    density_scale=params.density_scale)
        if params.light is not None:
            vals.update({k: getattr(params.light, k) for k in LIGHT_FIELDS})
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in vals.items()}
        return ({k: v.detach() for k, v in vals.items()},
                {k: g.detach() for k, g in grads.items()})

    def sample(self) -> list:
        """The jobs checked, drawn from the seed among those completed."""
        n = len(self.jobs)
        pick = np.random.default_rng([self.seed, 3]).choice(
            n, size=min(n, self.tr["check_jobs"]), replace=False)
        return [self.jobs[int(i)] for i in sorted(pick)]

    def reference_jobs(self, jobs, scene_=None, dtype=torch.float32) -> list:
        """[(losses, leaves after the job, each step's gradient)] of the
        reference following each job from its start, in ``dtype`` (the
        control, below float32), against the set-up's targets."""
        sc, tf, views = scene_ or self.reference_scene()
        samples = {}
        out = []
        for j, _, _ in jobs:
            cam = j % len(self.views)
            view = ref.View(*views[cam].unbind(0))
            if cam not in samples:  # one view's samples held at a time
                samples = {cam: ref.view_samples(sc, self.fr, view)}
            start = self.start_leaves(j, tf["colors"])
            t0 = time.perf_counter()
            out.append(ref.adam_fit(
                sc, self.fr, view, samples[cam], self.targets[cam], start,
                self.tr["steps"], self.tr["learning_rate"], dtype))
            print(f"reference job {j}: {time.perf_counter() - t0:.2f} s",
                  file=sys.stderr, flush=True)
        return out

    def check(self, answers=None):
        """-> (compared, jobs wrong or missing, the work of K4's traced
        launches).  ``answers`` replaces the program's sampled jobs'
        (losses, leaves, last gradient)."""
        jobs = self.sample()
        limits = self.cell.limits
        if answers is None:
            answers = []
            for _, params, losses in jobs:
                vals, grads = self._program_leaves(params)
                answers.append((losses, vals, grads))
        sc, tf, views = self.reference_scene()
        refs = self.reference_jobs(jobs, (sc, tf, views))
        values = dict.fromkeys(("loss_gap", "start_loss_gap", "grad_gap",
                                "change_gap"), 0.0 if jobs else math.inf)
        failed = 0
        for (j, _, _), (lp, vp, gp), (lr_, vr, gr) in zip(jobs, answers, refs):
            start = self.start_leaves(j, tf["colors"])
            gaps = ([abs(a - b) / abs(b) if b else math.inf
                     for a, b in zip(lp, lr_)] if len(lp) == len(lr_)
                    else [math.inf])
            lg, lg0 = max(gaps), max(gaps[:START_STEPS])
            print(f"job {j} loss gaps by step: "
                  + " ".join(f"{g:.2e}" for g in gaps), file=sys.stderr)
            gg = leaf_gaps(gp, gr[-1])
            print(f"job {j} last gradient, program / reference norms: "
                  + ", ".join(f"{k} {_norm(gp[k]):.6g} / {_norm(gr[-1][k]):.6g}"
                              for k in gr[-1]), file=sys.stderr)
            first = {k: _norm(g) for k, g in gr[0].items()}
            med = float(np.median(list(first.values())))
            still = {k for k, v in first.items() if v < STILL_SHARE * med}
            if still:
                print(f"job {j}: left out of the change: {sorted(still)}",
                      file=sys.stderr)
            cg = leaf_gaps({k: vp[k] - start[k] for k in vr},
                           {k: vr[k] - start[k] for k in vr}, still)
            mine = dict(loss_gap=lg, start_loss_gap=lg0, grad_gap=gg,
                        change_gap=cg)
            for k, v in mine.items():
                values[k] = max(values[k], v)
            if any(v > limits[k] for k, v in mine.items() if k in limits):
                failed += 1
        # a number the cell's limits leave out is reported, not compared
        for k in values.keys() - limits.keys():
            print(f"not compared: {k} {values[k]!r}", file=sys.stderr)
        compared = {k: dict(value=v, limit=limits[k])
                    for k, v in values.items() if k in limits}
        return compared, failed, {"K4": self._k4_work()}

    def _k4_work(self) -> list:
        """(operations, bytes) of each traced K4 launch: one a step, every
        sample of every ray at eps 0; a job's first step has the start's
        alpha of interval 0 off the volume, later steps Adam's."""
        dims = tuple(self.cell.config["volume"]["dims"])
        rays = self.fr.width * self.fr.height
        total = rays * self.fr.spr
        k = len(self.cell.config["transfer_function"]["lower_255"])
        a0_start = float(self.cell.config["transfer_function"]["colors"][0][3])
        work = []
        for j in self.traced_jobs:
            cam = j % len(self.views)
            for s in range(self.tr["steps"]):
                a0 = a0_start if s == 0 else 1.0
                work.append(kernels.k4_work(self.inside[cam], total, rays,
                                            dims, k, self.fr.lighting, a0))
        return work
