"""`factor_reuse.tick` (``metrics/factor_reuse.tick.py``): on a synthetic
trace, the reuse spans a unit under the tick's root; nothing from a program
that never checks for reuse; and on the CPU, a small traced run of
``push_recovery.fleet98k`` reads every traced tick as a reuse."""

import json
import time

import pytest
import torch

from portbench import program_spans
from portbench.harness import HERE, _module, execute

from conftest import ROOT, small_cell
from test_program_spans import TICK, context

METRIC = "factor_reuse.tick"
PUSH_CELLS = ("push_recovery.fleet98k", "push_recovery.ensemble2")
#: the tick of the synthetic trace, its factorization reused inside `dcm.factor` [10, 30]
REUSED_TICK = TICK + [("sync.factor_key", 11, 12, []), ("dcm.factor_reused", 12, 13, [])]


def read(ctx):
    return _module("metrics", METRIC).read(ctx)


@pytest.mark.parametrize("units", [1, 2, 3])
def test_one_reuse_a_tick_reads_one(units):
    assert read(context("fleet.tick", REUSED_TICK, units)) == pytest.approx(1.0)


def test_ticks_that_check_and_factor_anew_read_zero():
    missed = TICK + [("sync.factor_key", 11, 12, [])]
    assert read(context("fleet.tick", missed)) == 0.0


def test_a_reuse_outside_the_tick_does_not_count():
    assert read(context("gait.plan", REUSED_TICK, units=2)) is None
    assert program_spans.count(context("gait.plan", REUSED_TICK), "sync.*", "gait.plan") == 3


@pytest.mark.parametrize("parts", [TICK, []], ids=["factors_every_tick", "no_spans"])
def test_a_program_that_never_checks_gives_nothing(parts):
    """The parent of the change that added the reuse factors every tick and
    never checks: the metric is left out of its line rather than read as 0."""
    assert read(context("fleet.tick" if parts else "portbench.other", parts)) is None


def test_the_entry_and_the_spans_it_reads():
    from blf_tpu_torch.mpc import qp
    from blf_tpu_torch.parallel import sweep

    module = _module("metrics", METRIC)
    assert module.SPANS == [] and module.ROOT in sweep.SPANS
    assert {module.CHECK, module.REUSED} <= set(qp.SPANS)
    entries = [m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
               if m["name"] == METRIC]
    assert entries == [{"name": METRIC, "unit": "reuses/tick", "better": "higher",
                        "source": "program_span",
                        "layer": "factorization: mpc/qp.py factor_shared_qp",
                        "moves": "solves_per_s", "workloads": list(PUSH_CELLS)}]
    assert (HERE / "metrics" / f"{METRIC}.py").is_file()


def test_a_traced_push_run_reuses_every_traced_tick():
    """``push_recovery.ensemble2``'s reading is ``test_faults.py``'s (above 0)."""
    torch.set_num_threads(1)
    result = execute(small_cell(PUSH_CELLS[0], 8), 2 ** 31 + 977, 1.0, True,
                     torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["metrics"][METRIC] == {"value": 1.0, "unit": "reuses/tick"}
    assert result["metrics"]["syncs.tick"]["value"] == 6.0
