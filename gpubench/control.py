"""The comparison's readings on the card, for setting its limits: the
control (the benchmark's reference computed in bfloat16, put in the
program's place) or a planted break (``gpubench/faults.py``), at the
cell's own size, one JSON line per seed:

    python3 -m gpubench.control --workload <name> --seeds 1,2,3 \\
        [--kind control|stale|half|altered] [--seconds 5]

The control renders only the frames (or follows only the jobs) that a run
checks; a break runs the program with it planted for ``--seconds``.  The
sound program's readings are those of the benchmark's own runs
(``gpubench/run.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gpubench import faults, harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="control",
                    choices=("control",) + faults.KINDS)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = cell.driver.Driver(cell, seed, dev)
        if args.kind == "control":
            compared, failed, _ = drv.check(drv.control_answers())
        else:
            brk = faults.orbit if cell.traffic["driver"] == "orbit" else (
                faults.fit)
            with brk(args.kind):
                drv.setup()
                drv.window(args.seconds)
                drv.release()
            compared, failed, _ = drv.check()
        print(json.dumps(dict(workload=args.workload, kind=args.kind,
                              seed=seed, failed=failed, compared=compared,
                              seconds=time.perf_counter() - t0)), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
