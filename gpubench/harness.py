"""Resolve a cell of ``BENCHMARK.json`` to its files, run it, and report.

Everything a cell needs is found by the names its entry gives:
``gpubench/configs/<config>.json``, ``gpubench/traffic/<traffic>.json``,
the driver ``gpubench/drivers/<driver>.py`` that the traffic file names,
the comparison's limits ``gpubench/limits/<cell>.json``, and one reader
``gpubench/metrics/<metric>.py`` per per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in a run, by top-level name: JAX, the JAX
# package this port was made from, and the JAX package's benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "volumerenderingproject_tpu",
             "benchmarks")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]
    driver: object = field(repr=False, default=None)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, cell: str) -> Optional[bool]:
    ws = metric.get("workloads")
    return None if ws is None else cell in ws


def resolve(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of the benchmark with every file it names loaded."""
    bench = _json(bench_path)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    w = entries[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = _json(ROOT / files[w["config"]])
    traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _listed(m, name) is not False]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _listed(m, name) or (_listed(m, name) is None
                                         and m["moves"] in names)]
    limits = _json(HERE / "limits" / f"{name}.json")
    driver = importlib.import_module(f"gpubench.drivers.{traffic['driver']}")
    return Cell(name, config, traffic, int(w["chips"]), e2e, per_layer,
                limits, driver)


def reader(metric: str):
    """The ``read`` function of ``gpubench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of ``cell``: set-up, the measured window, with ``trace`` a
    traced window after it, the comparison with the reference -> the
    result (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown``, ``compared``)."""
    import torch

    drv = cell.driver.Driver(cell, seed, device)
    t_setup = time.perf_counter()
    drv.setup()
    # the benchmark's own reference work in set-up (a fit's targets) is the
    # yardstick's, not the program's: left out of ``setup_s``
    setup_s = time.perf_counter() - t_start - drv.reference_s
    print(f"set-up: {t_setup - t_start:.3f} s before the traffic driver's, "
          f"{setup_s - (t_setup - t_start):.3f} s in it, "
          f"{drv.reference_s:.3f} s of reference left out",
          file=sys.stderr)
    win = drv.window(seconds)
    by_second = [0] * max(1, math.ceil(win["window_s"]))
    for end, units in win["unit_ends"]:
        by_second[min(int(end), len(by_second) - 1)] += units
    print("units completed in each second of the window: "
          + " ".join(map(str, by_second)), file=sys.stderr)
    record = None
    if trace:
        from gpubench import tracing

        record = tracing.capture(drv.traced_window)
    cuda = drv.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(drv.device) if cuda else 0
    drv.release()
    t_check = time.perf_counter()
    compared, failed, work = drv.check()
    print(f"phases setup_s {setup_s:.3f} window_s {win['window_s']:.3f} "
          f"check_s {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    device_info = dict(_device_info(drv.device), memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=win["attempted"], failed=failed)
    metrics = {}
    if not trace:
        values = dict(win["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"the {cell.traffic['driver']} driver does "
                               f"not measure {m['name']}")
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
        out.update(metrics=metrics, device=device_info)
    else:
        record.update(units=win["traced_units"], work=work, peak_bytes=peak,
                      unit_ms=win.get("unit_ms"))
        for m in cell.per_layer:
            v = reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        device_info.update(busy_s=record["busy_s"],
                           window_s=record["window_s"])
        out.update(metrics=metrics, device=device_info,
                   breakdown=dict(device_ops=record["top_ops"],
                                  idle_gaps=record["idle_gaps"]))
    out["compared"] = compared
    # last, once the comparison and the readers have run: anything they or
    # the program loaded counts
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError("modules loaded that a run may not load: "
                           + ", ".join(leaked))
    return out


def report(result: dict, stream_out=None, stream_err=None) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error, then the result as the last line of standard output."""
    stream_out = stream_out or sys.stdout
    stream_err = stream_err or sys.stderr
    for name, v in result["compared"].items():
        verdict = "ok" if v["value"] <= v["limit"] else "OVER"
        print(f"compared {name} {v['value']!r} limit {v['limit']!r} "
              f"{verdict}", file=stream_err)
    stream_err.flush()
    print(json.dumps(result), file=stream_out)
    stream_out.flush()
