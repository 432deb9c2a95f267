"""The kernel build at first use (``ops/_build.py``) and the native build
(``native/build.py``) from several threads of one process: each thread
compiles into a temporary file of its own, and ``load`` builds and binds a
library once while the others wait.  No nvcc here: a stand-in compiler
script writes its ``-o`` file."""

import os
import stat
import threading

import pytest

from volumerenderingproject_tpu_torch import native
from volumerenderingproject_tpu_torch.native import build as native_build
from volumerenderingproject_tpu_torch.ops import _build

THREADS = 6

FAKE_COMPILER = """#!/bin/sh
# a compiler stand-in: logs its -o path, waits, writes the -o file
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "$out" >> "{log}"
sleep 0.3
echo "built" > "$out"
"""


@pytest.fixture
def fake_compiler(tmp_path):
    log = tmp_path / "calls.log"
    exe = tmp_path / "fake_nvcc"
    exe.write_text(FAKE_COMPILER.format(log=log))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return str(exe), log


@pytest.fixture
def fake_tree(tmp_path, monkeypatch, fake_compiler):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "nvcc", lambda: fake_compiler[0])
    monkeypatch.setattr(_build, "_loaded", {})
    return build_dir, fake_compiler[1]


def _in_threads(fn):
    """Run ``fn`` in THREADS threads started together -> their results; a
    thread's exception is raised here."""
    barrier = threading.Barrier(THREADS)
    results, errors = [None] * THREADS, []

    def run(i):
        try:
            barrier.wait(timeout=30)
            results[i] = fn()
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return results


def test_concurrent_builds_use_their_own_temporary_files(fake_tree):
    build_dir, log = fake_tree
    paths = _in_threads(lambda: _build.build(["fake"]))
    want = _build.library_path("fake")
    assert all(p == {"fake": want} for p in paths)
    assert want.read_text() == "built\n"
    tmps = log.read_text().split()
    assert len(tmps) == len(set(tmps)) >= 1
    assert all(t.startswith(str(want) + f".{os.getpid()}.") for t in tmps)
    assert sorted(os.listdir(build_dir)) == [want.name]


def test_concurrent_loads_bind_once(fake_tree, monkeypatch):
    _, log = fake_tree
    opened = []

    def cdll(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    libs = _in_threads(lambda: _build.load("fake"))
    assert len(opened) == 1 and len(log.read_text().split()) == 1
    assert all(lib is libs[0] for lib in libs)


def test_native_concurrent_builds(tmp_path, monkeypatch, fake_compiler):
    src = tmp_path / "vrputils.cpp"
    src.write_text("// a source\n")
    monkeypatch.setattr(native_build, "SOURCE", src)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", fake_compiler[0])
    paths = _in_threads(native_build.build)
    want = native_build.library_path()
    assert all(p == want for p in paths) and want.read_text() == "built\n"
    tmps = fake_compiler[1].read_text().split()
    assert len(tmps) == len(set(tmps)) >= 1
    assert sorted(os.listdir(tmp_path / "native")) == [want.name]


def test_native_concurrent_loads_bind_once(monkeypatch):
    calls = []

    def bind():
        calls.append(threading.get_ident())
        native._lib = object()
        return native._lib

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_bind", bind)
    libs = _in_threads(native.load)
    assert len(calls) == 1 and all(lib is libs[0] for lib in libs)
