"""Build the native host library (``native/vrputils.cpp``) at first use:
``python -m volumerenderingproject_tpu_torch.native.build``.

``g++ -O3 -std=c++17 -fPIC -shared -pthread`` compiles the source into
``build/native/`` at the repository root, named by a hash of the source and
the flags, so a changed source is rebuilt and an unchanged one is loaded as
it is.  A failed build raises, naming the compiler's error.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().with_name("vrputils.cpp")
BUILD_DIR = SOURCE.parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libvrputils-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built -> its path."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native build: no C++ compiler (g++ or $CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary file per process and thread
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({cxx} exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
