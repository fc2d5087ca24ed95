"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU at a
small size, once for each fault a cell can have (the exchange between chips
left out is ``test_mesh.py``'s fault, on four ranks)."""

import time

import pytest
import torch

import blf_tpu_torch.planners.gait as gait_module

from portbench.harness import execute
from portbench.paths.fleet_tick import FleetTick
from portbench.paths.gait_plan import GaitPlan

from conftest import small_cell

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242


def broken_tick(fault):
    class Broken(FleetTick):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            step = self.step

            def wrong(state, push, *refs):
                new, res = step(state, push, *refs)
                if fault == "unchanged":          # the state comes back as it went in
                    return state, res
                if fault == "half":               # half the lanes left out
                    h = new.dcm.shape[0] // 2
                    new = type(new)(*(torch.cat([n[:h], o[h:]]) for n, o in zip(new, state)))
                    z0 = res.consensus_zmp0.clone()
                    z0[h:] = 0.0
                    return new, res._replace(consensus_zmp0=z0)
                z0 = res.consensus_zmp0.clone()   # one answer altered where it is made
                z0[3, 0] += 1e-3
                return new, res._replace(consensus_zmp0=z0)

            self.step = wrong
    return Broken


def broken_plan_gait(fault, plan_gait):
    def wrong(*args, **kwargs):
        plan, schedule = plan_gait(*args, **kwargs)
        dcm, zmp = plan.dcm.clone(), plan.zmp.clone()
        if fault == "unchanged":                  # the initial iterate handed back
            dcm[:] = dcm[:, :1]
            zmp.zero_()
        elif fault == "half":
            h = dcm.shape[0] // 2
            dcm[h:], zmp[h:] = dcm[:h][: dcm.shape[0] - h], zmp[:h][: zmp.shape[0] - h]
        else:
            zmp[2, 40, 1] += 1e-3
        return plan._replace(dcm=dcm, zmp=zmp), schedule
    return wrong


@pytest.mark.parametrize("cell", ["push_recovery.fleet98k", "push_recovery.rt4096",
                                  "push_recovery.ensemble2"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_a_broken_tick_is_not_correct(cell, fault):
    c = small_cell(cell, 32)
    result = execute(c, SEED, 0.5, False, CPU, time.perf_counter(),
                     make_driver=FleetTick if fault is None else broken_tick(fault))
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_a_broken_plan_is_not_correct(fault, monkeypatch):
    if fault is not None:
        monkeypatch.setattr(gait_module, "plan_gait",
                            broken_plan_gait(fault, gait_module.plan_gait))
    c = small_cell("full_gait.sweep16k", 8)
    result = execute(c, SEED, 0.5, False, CPU, time.perf_counter(), make_driver=GaitPlan)
    assert result["correct"] is (fault is None), result["checks"]


@pytest.mark.parametrize("cell,lanes", [("push_recovery.fleet98k", 32),
                                        ("push_recovery.ensemble2", 16), ("full_gait.sweep16k", 8)])
def test_a_traced_run_reads_its_spans_inside_the_window(cell, lanes):
    c = small_cell(cell, lanes)
    result = execute(c, SEED, 1.5, True, CPU, time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    got = set(result["metrics"])
    # on the CPU the profiler sees no device operation: only the span times read
    spans = {m["name"] for m in c.per_layer if m["source"] == "program_span"}
    assert spans and got == spans, got
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert result["device"]["window_s"] > 0 and "proc_cpus" in result["host"]
