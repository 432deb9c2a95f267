"""No module of the benchmark imports JAX, the JAX package or its old
benchmarks (by whole top-level module name: the port's name begins with
the JAX package's); the reference and the counts import nothing of the
program; without a card a run fails and prints no result."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "gpubench"
FORBIDDEN = {"jax", "jaxlib", "flax", "volumerenderingproject_tpu",
             "benchmarks"}
PROGRAM = "volumerenderingproject_tpu_torch"


def imported(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_program(sub):
    for path in (PKG / sub).rglob("*.py"):
        assert PROGRAM not in imported(path), path
    code = "\n".join([
        "import importlib, pkgutil, sys",
        f"import gpubench.{sub} as pkg",
        "for m in pkgutil.iter_modules(pkg.__path__):",
        f"    importlib.import_module('gpubench.{sub}.' + m.name)",
        "top = {m.split('.')[0] for m in sys.modules}",
        f"print(sorted(top & set({sorted(FORBIDDEN | {PROGRAM})!r})))"])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", "lit700.orbit",
         "--seed", "2147483711", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_files_alone_are_not_enough(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""
