"""The readers of the program's own spans (``portbench/program_spans.py`` and
the six metric files that bind them) on a synthetic trace whose op counts,
busy times and sync counts are known by construction."""

import fnmatch
from types import SimpleNamespace

import pytest

from portbench import program_spans, readers, trace
from portbench.harness import HERE, _module

TICK_METRICS = ("boundary_ms.tick", "glue_ops.tick", "syncs.tick")
GAIT_METRICS = ("boundary_ms.gait", "planner_ops.gait", "syncs.gait")
PROGRAM_READERS = TICK_METRICS + GAIT_METRICS


def unit_events(root, parts, u, corr):
    """One unit at ``u`` (us): the harness's unit span [0, 100] and the root
    span [2, 98] on thread 1, then ``parts``: (name, start, end, [(launch,
    (device start, device end)), ...]), each launch matched to its device
    operation by a correlation id from ``corr``."""
    ev = []
    span = lambda name, s, e: ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                                         "ts": u + s, "dur": e - s, "tid": 1})
    span(readers.UNIT, 0, 100)
    span(root, 2, 98)
    for name, s, e, launches in parts:
        span(name, s, e)
        for launch, (ds, de) in launches:
            c = next(corr)
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": u + launch, "dur": 0.5, "tid": 1, "args": {"correlation": c}})
            ev.append({"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": u + ds,
                       "dur": de - ds, "tid": 7, "args": {"correlation": c}})
    # a sync span in the unit but outside the root, and a launch from another
    # thread inside a boundary's interval: neither counts
    span("sync.h2d", 98.5, 99)
    c = next(corr)
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": u + 43,
               "dur": 0.5, "tid": 2, "args": {"correlation": c}})
    ev.append({"ph": "X", "cat": "kernel", "name": "other_thread", "ts": u + 50, "dur": 2,
               "tid": 7, "args": {"correlation": c}})
    return ev


#: a stage boundary's union: [45, 49] and [65, 66], 5 us a unit
SOLVE = [("dcm.factor", 10, 30, [(21, (21, 24))]), ("sync.eigh", 20, 25, []),
         ("qp.stage", 30, 40, [(35, (35, 45))]),
         ("qp.boundary", 40, 50, [(42, (45, 47)), (44, (46, 49))]),
         ("qp.stage", 50, 60, [(55, (55, 62))]), ("qp.boundary", 60, 70, [(65, (65, 66))])]
#: 6 glue operations and 2 syncs inside the root a unit
TICK = [("dcm.transcribe", 3, 10, [(6, (10, 12)), (8, (12, 13))]), ("sync.h2d", 4, 5, []),
        *SOLVE, ("fleet.stats", 70, 80, [(75, (75, 76))]), ("fleet.advance", 80, 82, []),
        ("fleet.status", 82, 90, [(85, (85, 86)), (86, (86, 87)), (87, (87, 88))])]
#: 7 planner operations and 3 syncs inside the root a unit
GAIT = [("gait.schedule", 2.5, 3, []), ("gait.hulls", 3, 6, [(4, (4, 5)), (5, (5, 6))]),
        ("sync.h2d", 3.5, 4), ("gait.references", 6, 8, [(7, (7, 8))]),
        ("sync.h2d", 6.5, 7), ("dcm.transcribe", 8, 10, [(9, (9, 9.5))]),
        *SOLVE, ("dcm.rollout", 70, 80, [(71, (71, 72)), (72, (72, 73)), (73, (73, 74))])]


def context(root, parts, units=2, period=100.0):
    corr = iter(range(1, 10**6))
    parts = [p if len(p) == 4 else p + ([],) for p in parts]
    events = [e for i in range(units) for e in unit_events(root, parts, i * period, corr)]
    tr = trace.Trace(events)
    return SimpleNamespace(trace=tr, units=tr.named(readers.UNIT),
                           window=tr.window(readers.UNIT))


def read(metric, ctx):
    return _module("metrics", metric).read(ctx)


@pytest.mark.parametrize("units", [1, 2, 3])
def test_tick_readers_by_construction(units):
    ctx = context("fleet.tick", TICK, units)
    assert read("boundary_ms.tick", ctx) == pytest.approx(5e-3)
    assert read("glue_ops.tick", ctx) == pytest.approx(6.0)
    assert read("syncs.tick", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("units", [1, 2, 3])
def test_gait_readers_by_construction(units):
    ctx = context("gait.plan", GAIT, units)
    assert read("boundary_ms.gait", ctx) == pytest.approx(5e-3)
    assert read("planner_ops.gait", ctx) == pytest.approx(7.0)
    assert read("syncs.gait", ctx) == pytest.approx(3.0)


def test_spans_outside_the_profiled_stretch_do_not_count():
    ctx = context("fleet.tick", TICK, units=3)
    ctx.units = ctx.units[:2]
    ctx.window = (ctx.units[0].start, ctx.units[-1].end)
    assert read("glue_ops.tick", ctx) == pytest.approx(6.0)
    assert read("syncs.tick", ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", PROGRAM_READERS)
def test_readers_return_nothing_without_the_programs_spans(metric):
    """A program without spans (the parent of the change that added them)."""
    bare = context("portbench.other", [])
    assert read(metric, bare) is None


def test_syncs_read_zero_where_the_root_holds_none():
    ctx = context("fleet.tick", [p for p in TICK if not p[0].startswith("sync.")])
    assert read("syncs.tick", ctx) == 0.0
    assert read("glue_ops.tick", ctx) == pytest.approx(6.0)


def test_ops_need_device_operations():
    """A trace of the host alone (a profiler that saw no device activity)."""
    ctx = context("fleet.tick", TICK)
    ctx.trace = trace.Trace([{"ph": "X", "cat": "user_annotation", "name": s.name,
                              "ts": s.start, "dur": s.end - s.start, "tid": s.tid}
                             for s in ctx.trace.spans])
    assert not ctx.trace.ops
    assert read("glue_ops.tick", ctx) is None and read("boundary_ms.tick", ctx) is None
    assert program_spans.count(ctx, "sync.*", "fleet.tick") == pytest.approx(2.0)


def test_program_metric_files_name_documented_spans():
    from blf_tpu_torch.mpc import dcm, qp
    from blf_tpu_torch.parallel import sweep
    from blf_tpu_torch.planners import gait

    documented = set(sweep.SPANS + dcm.SPANS + qp.SPANS + gait.SPANS)
    for path in sorted((HERE / "metrics").glob("*.py")):
        module = _module("metrics", path.stem)
        names = getattr(module, "PROGRAM_SPANS", None)
        if names is None:
            continue
        assert module.SPANS == [], path.stem
        for name in names:
            assert fnmatch.filter(documented, name), (path.stem, name)
    assert {p.stem for p in (HERE / "metrics").glob("*.py")
            if hasattr(_module("metrics", p.stem), "PROGRAM_SPANS")} == set(PROGRAM_READERS)
