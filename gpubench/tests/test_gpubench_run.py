"""Whole runs of each cell, cut to CPU size (the program's plain versions
stand in for its kernels): a sound run comes out correct; each break the
cell can have, planted under the timed path, comes out not correct; the
control (the driver's ``control_answers``, the reference in bfloat16, as
``gpubench.control`` reads it on the card) comes out not correct with every
gap finite; a forbidden module loaded as late as the comparison leaves the
run with no result.  On a card, a short run of each cell at its full
size."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from gpubench import faults, harness
from gpubench.tests.conftest import CELLS

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 77


def _run(cell, seconds=0.4):
    return harness.run(cell, SEED, seconds, False, "cpu", time.perf_counter())


def test_sound_run_is_correct(tiny_cell):
    out = _run(tiny_cell)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {m["name"] for m in tiny_cell.end_to_end}
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("kind", faults.KINDS)
def test_broken_run_is_not_correct(tiny_cell, kind):
    brk = faults.orbit if tiny_cell.traffic["driver"] == "orbit" else (
        faults.fit)
    with brk(kind):
        out = _run(tiny_cell)
    assert not out["correct"], out["compared"]


def test_control_is_not_correct(tiny_cell):
    drv = tiny_cell.driver.Driver(tiny_cell, SEED, "cpu")
    compared, failed, _ = drv.check(drv.control_answers())
    values = {k: v["value"] for k, v in compared.items()}
    assert all(math.isfinite(v) for v in values.values()), values
    assert any(v["value"] > v["limit"] for v in compared.values()), compared
    assert failed > 0


def test_forbidden_module_loaded_in_the_check_gives_no_result(
        tiny_cell, monkeypatch):
    check = tiny_cell.driver.Driver.check

    def loads_jax(self, *a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return check(self, *a, **k)

    monkeypatch.setattr(tiny_cell.driver.Driver, "check", loads_jax)
    with pytest.raises(RuntimeError, match="jax"):
        _run(tiny_cell)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_run(card, cell):
    r = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
