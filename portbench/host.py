"""What the machine was doing while a run measured, read at the window's two
ends so that nothing runs inside it.

The host: the CPU seconds the whole process got (``getrusage``) over the
window's seconds, and a unit's share of them. A host-paced unit keeps one
thread busy throughout, so a run whose units are slower while the process
keeps the same share of a CPU ran the same work on a slower core. The card:
one ``nvidia-smi`` reading as the window closes, its SM clock against its
maximum, its power draw and limit and the active throttle reasons. A reading
the machine does not give is left out.
"""

from __future__ import annotations

import resource
import subprocess
import time
from typing import Dict

__all__ = ["mark", "between", "card"]

_GPU_FIELDS = ("clocks.sm", "clocks.max.sm", "power.draw", "power.limit", "temperature.gpu",
               "clocks_throttle_reasons.active")
_GPU_NAMES = ("sm_mhz", "sm_max_mhz", "power_w", "power_limit_w", "temp_c", "throttle")


def mark() -> tuple:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return time.perf_counter(), ru.ru_utime + ru.ru_stime


def between(a: tuple, b: tuple, units: int) -> Dict[str, float]:
    """The window's readings from its two marks and its count of units."""
    wall, cpu = b[0] - a[0], b[1] - a[1]
    out = {"proc_cpus": cpu / wall} if wall > 0 else {}
    if units:
        out["cpu_ms_per_unit"] = 1e3 * cpu / units
    return out


def card(index: int) -> Dict[str, object]:
    """One ``nvidia-smi`` reading of card ``index``; empty where it gives none."""
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index),
                              "--query-gpu=" + ",".join(_GPU_FIELDS),
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    got: Dict[str, object] = {}
    for name, v in zip(_GPU_NAMES, out.stdout.strip().splitlines()[0].split(",")):
        try:
            got[name] = v.strip() if name == "throttle" else float(v)
        except ValueError:
            continue
    return got
