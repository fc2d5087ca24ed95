"""The trace reader and the metric readers on a synthetic trace whose idle
share, counts, extents and self times are known by construction."""

"""The trace reader and the metric readers on a synthetic trace and synthetic
span timings whose idle share, counts, extents and rooflines are known by
construction."""

from types import SimpleNamespace

import pytest

from portbench import peaks, readers, spans, trace
from portbench.harness import HERE, _module, _reader

K1_SHAPES = ((1024, 192), None, None, None, None, None, (192, 128))
K1_CALL = spans.Timed(K1_SHAPES, {"iters": 25}, 0.0)
PLAN, FACTOR, SOLVE, K1 = (_module("metrics", "planner_ms.gait").SPANS
                           + _module("metrics", "k1_roofline.tick").SPANS)


def synthetic(units=2, period=100.0):
    """Each unit (one thread, times in us from its start u): spans unit [0,
    100], plan_gait [5, 95], factor [10, 30], solve [30, 80], k1 [40, 50];
    launches at 15 (factor), 35 (solve), 45 (k1), 90 (after the solve); the
    device runs them at [16, 20], [50, 55], [60, 70], [90, 95]."""
    ev, corr = [], 0
    span = lambda name, s, e: ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                                         "ts": s, "dur": e - s, "tid": 1})
    for i in range(units):
        u = i * period
        span(readers.UNIT, u, u + 100)
        span(PLAN, u + 5, u + 95)
        span(FACTOR, u + 10, u + 30)
        span(SOLVE, u + 30, u + 80)
        span(K1, u + 40, u + 50)
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::linalg_eigh", "ts": u + 11,
                   "dur": 15, "tid": 1})
        for launch, (s, e), name, cat in ((15, (16, 20), "eigh_kernel", "kernel"),
                                          (35, (50, 55), "axpy", "kernel"),
                                          (45, (60, 70), "admm_stage_tc_kernel", "kernel"),
                                          (90, (90, 95), "Memcpy DtoH", "gpu_memcpy")):
            corr += 1
            ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": u + launch, "dur": 1, "tid": 1, "args": {"correlation": corr}})
            ev.append({"ph": "X", "cat": cat, "name": name, "ts": u + s, "dur": e - s,
                       "tid": 7, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "kernel", "name": "stray", "ts": 5000, "dur": 3, "tid": 7,
               "args": {"correlation": 99999}})
    return ev


def timed(ms):
    return spans.Timed((), {}, ms)


def context(units=2, span_units=3, unit_s=40e-6):
    """The span stretch: ``span_units`` units, each with a plan of 2.0 ms
    holding a factor of 0.25 ms and two solves of 0.5 ms."""
    tr = trace.Trace(synthetic(units))
    calls = {PLAN: [timed(2.0)] * span_units, FACTOR: [timed(0.25)] * span_units,
             SOLVE: [timed(0.5)] * (2 * span_units)}
    return SimpleNamespace(trace=tr, units=tr.named(readers.UNIT),
                           window=tr.window(readers.UNIT), calls=calls, span_units=span_units,
                           traced_calls={K1: [K1_CALL] * units}, unit_s=unit_s)


def test_intervals():
    assert trace.union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.length([(0, 2), (1, 3)]) == 3
    assert trace.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]


def test_trace_counts_and_matching():
    ctx = context()
    assert ctx.window == (0.0, 200.0)
    assert len(ctx.trace.ops) == 9 and ctx.trace.unmatched == 1
    assert len(ctx.trace.ops_in(*ctx.window)) == 8


@pytest.mark.parametrize("units", [1, 2, 3])
def test_readers_by_construction(units):
    ctx = context(units)
    assert readers.device_ops(ctx) == 4
    assert readers.busy_ms(ctx) == pytest.approx(24e-3)
    # 24 us of device work a unit against an untraced unit of 40 us
    assert readers.idle_pct(ctx) == pytest.approx(100.0 * (1 - 24.0 / 40.0))
    assert readers.span_ms(ctx, FACTOR) == pytest.approx(0.25)
    assert readers.span_ms(ctx, SOLVE) == pytest.approx(1.0)
    assert readers.rest_ms(ctx, PLAN, (FACTOR, SOLVE)) == pytest.approx(0.75)
    bound = peaks.k1_bound_s(1024, 192, 128, 25)
    k1 = _module("metrics", "k1_roofline.tick")
    assert k1.bound_s(K1_CALL) == bound
    assert readers.roofline_pct(ctx, K1, k1.bound_s) == pytest.approx(100.0 * bound / 10e-6)
    assert k1.read(ctx) == readers.roofline_pct(ctx, K1, k1.bound_s)
    assert _reader("metrics", "planner_ms.gait")(ctx) == pytest.approx(0.75)


def test_readers_return_nothing_without_their_spans():
    tr = trace.Trace([e for e in synthetic() if e["name"] not in (K1, SOLVE)])
    ctx = SimpleNamespace(trace=tr, units=tr.named(readers.UNIT), window=tr.window(readers.UNIT),
                          calls={}, span_units=3, traced_calls={}, unit_s=None)
    assert readers.roofline_pct(ctx, K1, lambda c: 1.0) is None
    assert readers.span_ms(ctx, SOLVE) is None and readers.rest_ms(ctx, PLAN, [SOLVE]) is None
    assert readers.idle_pct(ctx) is None
    ctx.trace = trace.Trace([e for e in synthetic() if e["cat"] == "user_annotation"])
    assert readers.device_ops(ctx) is None and readers.busy_ms(ctx) is None


def test_breakdown():
    ctx = context()
    b = ctx.trace.breakdown([(u.start, u.end) for u in ctx.units], tid=1)
    ops = dict(b["device_ops"])
    assert ops["admm_stage_tc_kernel"] == pytest.approx(20e-6)
    assert sum(ops.values()) == pytest.approx(48e-6)
    gaps = dict(b["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(152e-6)
    # a unit's gaps [20, 50], [55, 60] and [70, 90] have their middles in the
    # solve span [30, 80]; [0, 16] in plan_gait, [95, 100] in the unit alone
    assert gaps[SOLVE] == pytest.approx(2 * (30e-6 + 5e-6 + 20e-6))
    assert gaps[PLAN] == pytest.approx(2 * 16e-6)
    assert gaps[readers.UNIT] == pytest.approx(2 * 5e-6)
    # a gap between two units (a paced cell's wait) is no unit's
    far = trace.Trace(synthetic(2, period=300.0))
    units = far.named(readers.UNIT)
    b2 = far.breakdown([(u.start, u.end) for u in units], tid=1)
    assert sum(dict(b2["idle_gaps"]).values()) == pytest.approx(152e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_every_metric_file_reads():
    for path in sorted((HERE / "metrics").glob("*.py")) + sorted((HERE / "e2e").glob("*.py")):
        assert callable(_reader(path.parent.name, path.stem))


def test_every_span_a_metric_names_is_a_function_of_the_program():
    import importlib

    for path in sorted((HERE / "metrics").glob("*.py")):
        for target in _module("metrics", path.stem).SPANS:
            module, attr = target.split(":")
            assert callable(getattr(importlib.import_module(module), attr)), (path.stem, target)


def test_patched_marks_each_call_and_restores():
    import torch

    import blf_tpu_torch.mpc.dcm as dcm

    original = dcm.factor_shared_qp
    clock = spans.Clock(torch.device("cpu"))
    with spans.patched([FACTOR, FACTOR], clock) as calls:
        assert dcm.factor_shared_qp is not original
        P = torch.eye(3, dtype=torch.float64)
        A = torch.ones((2, 3), dtype=torch.float64)
        dcm.factor_shared_qp(P, A, torch.tensor([True, False]), scaling_iters=2)
    assert dcm.factor_shared_qp is original
    (call,) = calls[FACTOR]
    assert call.shapes == ((3, 3), (2, 3), (2,)) and call.ints == {"scaling_iters": 2}
    (t,) = spans.timed(calls, clock)[FACTOR]
    assert t.ms >= 0.0
