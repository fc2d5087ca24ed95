"""The port's spans (``blf_tpu_torch/utils/profiling.py::trace``) on the CPU.

Under ``torch.profiler`` a fleet tick (B = 8, 2 stages; a step's first tick,
which factors, and a later one, which reuses the factors after a check) and
a gait plan (B = 4, 2 stages) emit every span their paths run, nested as the
modules' ``SPANS`` document them; off, ``trace`` is one shared object that opens
nothing; ``recording()`` keeps rows whose ids, units and host times nest and
whose self times add up to the roots'; the stack, the SQP and the
identification emit their part spans.
"""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blf_tpu_torch.convert import lipm_params_from_numpy
from blf_tpu_torch.mpc import dcm as tdcm
from blf_tpu_torch.mpc import qp as tqp
from blf_tpu_torch.mpc import sqp as tsqp
from blf_tpu_torch.mpc import stack as tstack
from blf_tpu_torch.parallel import sweep as tsweep
from blf_tpu_torch.planners import gait as tgait
from blf_tpu_torch.problems import (IDENTIFY_PARTS, contact_identification_fleet,
                                    dcm_planner_fleet, identify_contacts, push_recovery_stack,
                                    stack_fleet_step, stationary_push_recovery)
from blf_tpu_torch.utils import profiling

torch.set_num_threads(1)

B, H, DT = 8, 8, 0.1
QP = dict(iterations=50, check_every=25)          # two stages

#: each span of a step's first tick, which factors, and the span it opens
#: inside (None: the root)
FIRST_TICK_PARENTS = {"fleet.tick": None, "dcm.transcribe": "fleet.tick",
                      "dcm.factor": "fleet.tick", "sync.cholesky": "dcm.factor",
                      "sync.eigh": "dcm.factor", "qp.prepare": "fleet.tick",
                      "qp.stage": "fleet.tick", "qp.boundary": "fleet.tick",
                      "qp.finish": "fleet.tick", "dcm.rollout": "fleet.tick",
                      "fleet.stats": "fleet.tick", "fleet.advance": "fleet.tick",
                      "fleet.rls": "fleet.tick", "fleet.status": "fleet.tick"}
#: a later tick on the same operator: the last tick's factors are reused after
#: the check of what they were made from
TICK_PARENTS = {**{k: v for k, v in FIRST_TICK_PARENTS.items()
                   if k not in ("sync.cholesky", "sync.eigh")},
                "sync.factor_key": "dcm.factor", "dcm.factor_reused": "dcm.factor"}
GAIT_PARENTS = {"gait.plan": None, "gait.schedule": "gait.plan", "gait.hulls": "gait.plan",
                "gait.references": "gait.plan",
                **{k: ("gait.plan" if v == "fleet.tick" else v)
                   for k, v in FIRST_TICK_PARENTS.items() if not k.startswith("fleet.")}}
#: where the copies from the host that wait for the device lie
TICK_H2D = Counter({"fleet.tick": 1, "dcm.transcribe": 3, "fleet.rls": 1})
FIRST_TICK_H2D = TICK_H2D + Counter({"dcm.factor": 1})
GAIT_H2D = Counter({"gait.hulls": 2, "gait.references": 1, "dcm.transcribe": 2,
                    "dcm.factor": 1})
SPAN_NAMES = set(tsweep.SPANS + tdcm.SPANS + tqp.SPANS + tgait.SPANS)


def fleet_tick(first=False):
    """A tick of one step, or with ``first`` the first tick of a new step each call."""
    pr = stationary_push_recovery(B, H, seed=0, device="cpu", dtype=torch.float32)
    params = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float32)
    make = lambda: tsweep.make_fleet_step(params, DT, device="cpu", **QP)
    step = make()
    state = tsweep.init_fleet(B, H, pr.num_constraints, [0.01, -0.01], [0.01, -0.01],
                              device="cpu", dtype=torch.float32)
    tick = lambda step: step(state, pr.disturbance, pr.dcm_ref, pr.zmp_ref, pr.poly_A,
                             pr.poly_b)
    return (lambda: tick(make())) if first else (lambda: tick(step))


def first_fleet_tick():
    return fleet_tick(first=True)


def gait_plan():
    params = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float32)
    lists = tgait.footstep_plan(2, 0.15)
    dcm0 = torch.linspace(-0.01, 0.01, 8).reshape(4, 2)
    return lambda: tgait.plan_gait(params, lists, DT, dcm0, dcm0, shared=True, **QP)


def profiled_spans(run):
    """The program's spans of one call of ``run`` under the profiler, as
    (name, start, end) in the order they open."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name in SPAN_NAMES]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def parents(spans):
    """Each span's innermost enclosing span, by the host intervals."""
    out = []
    for i, (name, s, e) in enumerate(spans):
        holders = [o for j, o in enumerate(spans) if j != i and o[1] <= s and e <= o[2]]
        out.append((name, min(holders, key=lambda o: o[2] - o[1])[0] if holders else None))
    return out


@pytest.mark.parametrize("path, expected, h2d", [
    (fleet_tick, TICK_PARENTS, TICK_H2D), (gait_plan, GAIT_PARENTS, GAIT_H2D),
    (first_fleet_tick, FIRST_TICK_PARENTS, FIRST_TICK_H2D)],
    ids=["fleet_tick", "gait_plan", "fleet_tick_first"])
def test_path_emits_its_spans_nested_under_the_profiler(path, expected, h2d):
    run = path()
    run()                                            # warm: first calls allocate
    nested = parents(profiled_spans(run))
    counts = Counter(name for name, _ in nested)
    assert set(counts) == set(expected) | {"sync.h2d"}
    for name, parent in nested:
        if name != "sync.h2d":
            assert parent == expected[name], (name, parent)
    assert counts["qp.stage"] == counts["qp.boundary"] == 2
    assert all(counts[name] == 1 for name in expected if name not in ("qp.stage", "qp.boundary"))
    assert Counter(parent for name, parent in nested if name == "sync.h2d") == h2d


def test_trace_off_is_one_shared_object_that_opens_nothing(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.trace("fleet.tick") is profiling.trace("qp.stage")

    def refuse(*args, **kwargs):
        raise AssertionError("a span opened something while tracing was off")

    run = fleet_tick()
    for target, attr in ((torch.profiler, "record_function"), (torch.cuda, "Event"),
                         (torch.cuda.nvtx, "range_push"), (torch.cuda.nvtx, "range_pop")):
        monkeypatch.setattr(target, attr, refuse)
    state, result = run()
    assert state.dcm.shape == (B, 2) and result.status.shape == (B,)


def test_recording_rows_nest_and_self_times_add_up():
    run = fleet_tick()
    run()
    with profiling.recording() as log:
        run()
        run()
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
    assert profiling.trace("fleet.tick") is profiling.trace("qp.stage")   # off again
    rows = log.rows()
    assert [r.id for r in rows] == list(range(len(rows)))
    roots = [r for r in rows if r.parent is None]
    assert [r.name for r in roots] == ["fleet.tick", "fleet.tick"]
    assert [r.unit for r in roots] == [0, 1]
    by_id = {r.id: r for r in rows}
    for r in rows:
        assert r.host_start_ns <= r.host_end_ns
        assert r.device_start_ns is None and r.device_end_ns is None
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.id < r.id and r.unit == p.unit
            assert p.host_start_ns <= r.host_start_ns and r.host_end_ns <= p.host_end_ns
            assert TICK_PARENTS.get(r.name, p.name) == p.name
    assert Counter(r.unit for r in rows) == Counter({0: len(rows) // 2, 1: len(rows) // 2})

    summary = log.summary()
    assert summary["fleet.tick"]["count"] == 2 and summary["qp.stage"]["count"] == 4
    assert summary["sync.h2d"]["count"] == 2 * sum(TICK_H2D.values())
    root_ms = sum(1e-6 * (r.host_end_ns - r.host_start_ns) for r in roots)
    assert summary["fleet.tick"]["host_ms"] == pytest.approx(root_ms)
    assert sum(s["self_ms"] for s in summary.values()) == pytest.approx(root_ms)
    assert all(0.0 <= s["self_ms"] <= s["host_ms"] + 1e-9 and s["device_ms"] is None
               for s in summary.values())


def run_stack():
    problem = push_recovery_stack(4, seed=0, device="cpu", dtype=torch.float32)
    step = stack_fleet_step(problem)
    step(problem.state, problem.pushes, *problem.refs)


def run_sqp():
    from blf_tpu_torch.mpc.dcm_planner import plan_time_varying_dcm_batch

    fleet = dcm_planner_fleet(2, 8, seed=0, device="cpu", dtype=torch.float32)
    plan_time_varying_dcm_batch(*fleet, sqp=tsqp.SQPConfig(iterations=1, al_iterations=1))


def run_identification():
    problem = contact_identification_fleet(4, samples=4, seed=0, device="cpu",
                                           dtype=torch.float32)
    identify_contacts(problem, backend="torch")


@pytest.mark.parametrize("run, prefix, parts", [
    (run_stack, "stack", tstack.PARTS), (run_sqp, "sqp", tsqp.PARTS),
    (run_identification, "identify", IDENTIFY_PARTS)], ids=["stack", "sqp", "identify"])
def test_part_spans(run, prefix, parts):
    with profiling.recording() as log:
        run()
    summary = log.summary()
    assert {f"{prefix}.{part}" for part in parts} <= set(summary)
    assert all(summary[f"{prefix}.{part}"]["count"] >= 1 for part in parts)
