"""Shared fixtures of the benchmark's tests: cells of BENCHMARK.json cut to
a size the CPU runs in seconds (the program's plain PyTorch versions stand
in for its kernels there), and the ``card`` marker for tests that need an
NVIDIA GPU."""

from __future__ import annotations

import copy
import dataclasses
import json

import pytest
import torch

from gpubench import harness

TINY_DIMS = [14, 17, 12]
TINY_RENDER = dict(width=12, height=10)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def tiny(cell: harness.Cell, spr: int = 40) -> harness.Cell:
    """``cell`` with its volume, image and samples cut to CPU size, the
    shells' radii scaled with the grid, fewer frames and jobs."""
    c = dataclasses.replace(cell, config=copy.deepcopy(cell.config),
                            traffic=copy.deepcopy(cell.traffic))
    vol = c.config["volume"]
    scale = [t / d for t, d in zip(TINY_DIMS, vol["dims"])]
    vol["dims"] = list(TINY_DIMS)
    vol["radii"] = [r * s for r, s in zip(vol["radii"], scale)]
    c.config["render"].update(TINY_RENDER, samples_per_ray=spr)
    tr = c.traffic
    if tr["driver"] == "orbit":
        tr.update(warmup_frames=1, check_frames=3, trace_frames=4,
                  step_degrees=30.0)
    else:
        tr.update(steps=3, warmup_jobs=1, check_jobs=2, trace_jobs=1)
    return c


CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(params=CELLS)
def tiny_cell(request):
    return tiny(harness.resolve(request.param))
