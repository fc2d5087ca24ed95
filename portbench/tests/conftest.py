"""Tests of the benchmark itself, on the CPU at small sizes:

    python -m pytest portbench/tests -q

Tests marked ``chip`` need a CUDA card and skip without one (the check is made
in the ``cuda_device`` fixture, never at import); run them on the card with
``python -m pytest portbench/tests -q -m chip``.
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs only there")
    return torch.device("cuda", 0)


#: cells whose traffic and limits portbench holds but BENCHMARK.json does not
#: list (PERF.md, Open questions): the tests add their entries
HELD = {"push_recovery.rt4096": ("push_recovery", "rt4096", 1),
        "push_recovery.mesh2x2": ("push_recovery", "mesh2x2", 4)}


def bench():
    """BENCHMARK.json with the held cells' entries."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {w["name"] for w in b["workloads"]}
    b["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": k, "why": "held"}
                       for n, (c, t, k) in HELD.items() if n not in listed]
    return b


def small_cell(name, lanes, **traffic):
    """A cell of BENCHMARK.json, or a held one, with its traffic cut to a size
    the CPU holds."""
    from portbench.harness import load_cell

    cell = load_cell(name, bench())
    cell.traffic.update(lanes=lanes, warmup_units=3, traced_units=2, **traffic)
    if "pool" in cell.traffic:
        cell.traffic["pool"] = 3
    return cell
