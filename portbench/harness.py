"""Run one cell of ``BENCHMARK.json`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``, from the start of the process): the imports, the
device, the inputs made from the seed, the program's objects, the build or
load of its kernels and the traffic's warm-up units. Then the window: units
for ``--seconds``, back to back or, where the traffic states ``rate_hz``, one
started every period (a unit that starts late counts its lateness). Each unit
is timed by a pair of CUDA events on the idle stream, from the call into the
program until its results are on the host.

With ``--trace 1``, past the window's first half, two stretches of
``traced_units`` units read the per-layer metrics: the first with spans
around the calls their files name (``SPANS``; :mod:`portbench.spans`), each
marked on the device's clock, the second also under ``torch.profiler``; see
:mod:`portbench.readers`. After the window: the host's and the card's
readings over it (:mod:`portbench.host`), the peak memory, the check that no
JAX module is loaded, the program's state freed, and the sampled units
compared with the plain reference against the cell's limits
(``limits/<cell>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, ``host``, and last ``checks``, each compared number with its
limit (also the last lines of standard error).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Callable, List, Optional

import torch

from portbench import host, peaks, readers
from portbench.spans import Clock, patched, timed
from portbench.trace import Trace
from portbench.world import (ADDR_VAR, World, argv_of_this_process, free_address, start_ranks,
                             stop_ranks, this_rank)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "blf_tpu")

__all__ = ["Cell", "load_cell", "execute", "main", "FORBIDDEN", "forbidden_modules"]


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def _module(directory: str, name: str) -> ModuleType:
    """``<directory>/<name>.py`` (a file per metric)."""
    path = HERE / directory / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{directory}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reader(directory: str, name: str) -> Callable:
    return _module(directory, name).read


class Cell(SimpleNamespace):
    """One entry of ``workloads`` with everything it names: its
    configuration, traffic and limits, and the metrics it reports."""


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if m["moves"] in moved and _reports(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=_json(ROOT / cfg["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"), end_to_end=e2e,
                per_layer=layers)


def driver_class(config: dict):
    return importlib.import_module(f"portbench.paths.{config['path']}").DRIVER


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Pace:
    """Starts units back to back, or one every ``1 / rate_hz`` seconds from
    ``t0``; ``wait()`` returns how late (ms) the unit starts."""

    def __init__(self, rate_hz: float, t0: float):
        self.rate_hz = rate_hz
        self.period = 1.0 / rate_hz if rate_hz else 0.0
        self.due = t0

    def wait(self) -> float:
        if not self.period:
            return 0.0
        now = time.perf_counter()
        if now < self.due:
            time.sleep(self.due - now)
            now = time.perf_counter()
        late = max(0.0, now - self.due)
        self.due += self.period
        return 1e3 * late


def _stretches(cell: Cell, metrics: List[ModuleType], driver, device, pace) -> SimpleNamespace:
    """The two stretches of a traced run (see :mod:`portbench.readers`)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    n = int(cell.traffic["traced_units"])
    targets = sorted({t for m in metrics for t in getattr(m, "SPANS", [])})
    clock = Clock(device)
    attempted = failed = 0
    with patched(targets, clock) as calls:
        for _ in range(n):
            pace.wait()
            a, f = driver.unit()
            attempted, failed = attempted + a, failed + f
        _sync(device)
    calls = timed(calls, clock)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with patched(targets, clock) as traced_calls, profile(activities=activities) as prof:
        for _ in range(n):
            pace.wait()
            with record_function(readers.UNIT):
                a, f = driver.unit()
            attempted, failed = attempted + a, failed + f
        _sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = _json(path)["traceEvents"]
    return SimpleNamespace(calls=calls, span_units=n, events=events,
                           traced_calls=dict(traced_calls), units=2 * n,
                           attempted=attempted, failed=failed)


def _per_layer(cell: Cell, metrics: List[ModuleType], stretch, unit_ms, world=None) -> tuple:
    tr = Trace(stretch.events)
    units = tr.named(readers.UNIT)
    window = tr.window(readers.UNIT)
    if window is None:
        raise RuntimeError("the traced stretch holds no unit span")
    ctx = SimpleNamespace(trace=tr, units=units, window=window, calls=stretch.calls,
                          span_units=stretch.span_units, traced_calls=stretch.traced_calls,
                          unit_s=1e-3 * sum(unit_ms) / len(unit_ms) if unit_ms else None,
                          config=cell.config, traffic=cell.traffic, cell=cell.name)
    out = {}
    for m, module in zip(cell.per_layer, metrics):
        value = module.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    # the units' own time: a paced cell's waits between units are no one's work
    stretches = [(u.start, u.end) for u in units]
    busy = sum(e - s for lo, hi in stretches for s, e in tr.busy(lo, hi)) * 1e-6
    print(f"trace: {len(tr.ops)} device operations, {tr.unmatched} without a matched launch,"
          f" {len(units)} units", file=sys.stderr)
    if world is not None:                       # busy seconds averaged over the chips
        busy = world.sum([busy])[0] / world.size
    return out, {"busy_s": busy, "window_s": sum(hi - lo for lo, hi in stretches) * 1e-6}, \
        tr.breakdown(stretches, units[0].tid)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not measured"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
            started: float, make_driver: Optional[Callable] = None, world=None) -> dict:
    """Set-up, window, checks; returns the result line's object (``checks``
    last) or raises. ``make_driver`` replaces the configuration's driver
    class (the tests' faults). With a ``world`` (a cell on several chips)
    every rank runs this in step: rank 0 decides when the window closes and
    when its traced stretches start, counts and peaks are summed or
    maximised over the ranks, and each rank judges its own shard, the worst
    of them counting."""
    cls = make_driver or driver_class(cell.config)
    metrics = [_module("metrics", m["name"]) for m in cell.per_layer] if trace else []
    driver = cls(cell.config, cell.traffic, seed, device, world=world)
    _sync(device)
    built = time.perf_counter() - started
    driver.warm()
    _sync(device)
    setup_s = time.perf_counter() - started
    print(f"set-up: {built:.3f} s to the program's objects, {setup_s - built:.3f} s of warm-up",
          file=sys.stderr)

    agree = (lambda go: go) if world is None else world.agree
    clock = Clock(device)
    driver.begin_window()
    attempted = failed = 0
    stretch, marks, lateness = None, [], []
    before = host.mark()
    t0 = time.perf_counter()
    deadline, halfway = t0 + seconds, t0 + 0.5 * seconds
    pace = _Pace(float(cell.traffic.get("rate_hz", 0.0)), t0)
    while agree(time.perf_counter() < deadline):
        if trace and stretch is None and agree(time.perf_counter() >= halfway):
            untraced = len(marks)
            stretch = _stretches(cell, metrics, driver, device, pace)
            attempted, failed = attempted + stretch.attempted, failed + stretch.failed
            print(f"stretches: {time.perf_counter() - halfway:.2f} s", file=sys.stderr)
            pace = _Pace(pace.rate_hz, time.perf_counter())   # the profiler's export is no one's wait
            continue
        lateness.append(pace.wait())
        a = clock.mark()
        lanes, bad = driver.unit()
        marks.append((a, clock.mark()))
        attempted, failed = attempted + lanes, failed + bad
    _sync(device)
    window_s = time.perf_counter() - t0
    after = host.mark()
    readings = host.between(before, after, len(marks) + (stretch.units if stretch else 0))
    if device.type == "cuda":
        readings.update(host.card(device.index))
    unit_ms = [clock.ms(a, b) + late for (a, b), late in zip(marks, lateness)]
    units_run = len(marks) + (stretch.units if stretch is not None else 0)
    if unit_ms:
        q = sorted(unit_ms)
        print(f"window: {window_s:.3f} s, {len(q)} untraced units, ms: min {q[0]:.3f} median"
              f" {q[len(q) // 2]:.3f} max {q[-1]:.3f}; set-up {setup_s:.3f} s", file=sys.stderr)
    print("host: " + ", ".join(f"{k} {v}" for k, v in readings.items()), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    if world is not None:                       # all ranks' lanes; the fullest chip
        attempted, failed = (int(v) for v in world.sum([attempted, failed]))
        peak = int(world.max([peak])[0])

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                  else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        if stretch is None:
            raise RuntimeError("the window closed before its traced stretches")
        layer, busy, breakdown = _per_layer(cell, metrics, stretch,
                                            unit_ms[:untraced], world)
        result["metrics"] = layer
        result["device"].update(busy)
        result["breakdown"] = breakdown
    else:
        run = SimpleNamespace(units=len(unit_ms), unit_ms=unit_ms, window_s=window_s,
                              attempted=attempted, setup_s=setup_s)
        for m in cell.end_to_end:
            value = _reader("e2e", m["name"])(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["host"] = readings

    driver.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared = driver.compare("float64")
    if world is not None:
        keys = sorted(compared)
        compared = dict(zip(keys, world.max([compared[k] for k in keys])))
    missing = sorted(set(cell.limits) - set(compared))
    if missing:
        raise RuntimeError(f"no reading of the limited numbers {missing}")
    checks = {k: {"value": compared[k], "limit": cell.limits[k]} for k in sorted(cell.limits)}
    # a NaN reading compares false, so it fails its limit
    result["correct"] = units_run > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"modules loaded that the benchmark may not load: {found}")


def main(argv: List[str], started: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s), found {count}",
              file=sys.stderr)
        return 3
    rank, world, ranks = this_rank(), None, []
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    if rank == 0:
        print(f"card: {power_limit()}; peaks: {peaks.SPEC}", file=sys.stderr)
    try:
        if cell.chips > 1:
            address = os.environ.get(ADDR_VAR) or free_address()
            if rank == 0:
                ranks = start_ranks(argv_of_this_process(), cell.chips, address)
            world = World(rank, cell.chips, address, device)
        result = execute(cell, args.seed, args.seconds, bool(args.trace), device, started,
                         world=world)
        if world is not None:
            world.close()
    except ForbiddenModules as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 4
    finally:
        codes = stop_ranks(ranks, timeout=120)
    if rank != 0:
        return 0
    if any(codes):
        print(f"portbench: a rank failed, exit codes {codes}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
