"""One run of one cell of the port's benchmark:

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  It needs an NVIDIA GPU (it exits 2 without
one, printing no result), makes the cell's inputs on the card from the
seed, warms up the cell's shapes, drives the cell's traffic through the
program (``volumerenderingproject_tpu_torch``) for ``--seconds``, checks
what the window produced against the benchmark's reference, and prints one
JSON line: the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics from a traced window after the measured one with ``--trace 1``.
"""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (to the kernel's
    clock tick), or this module's import where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return T_IMPORT
    now = time.perf_counter()
    return now - age if 0.0 <= age < now - T_IMPORT + 60.0 else T_IMPORT


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every compile cache inside the checkout, at a fixed path (the
    # kernels' nvcc builds go to build/kernels/ already)
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    # one process with few threads: the host paces the frames, and spare
    # threads only contend for the shared host's cores
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    from gpubench import harness

    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t_start)
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
