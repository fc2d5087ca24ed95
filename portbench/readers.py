"""The arithmetic of the metric readers under ``metrics/`` (per layer) and
``e2e/`` (end to end). A reader file binds one of these to a metric's name,
and a per-layer one names in ``SPANS`` the program's functions it needs a
span around (:mod:`portbench.spans`). A reader that finds nothing to read
returns None, and the harness leaves that metric out.

A ``--trace 1`` run reads its per-layer metrics from inside the window, past
its first half, in two stretches of the same number of units: one with the
spans alone, each call marked on the device's clock (``ctx.calls``,
``ctx.span_units``), and one under ``torch.profiler`` (``ctx.trace``,
``ctx.units``, ``ctx.window``, ``ctx.traced_calls``). The profiler slows the
host, so times of host-paced work come from the first stretch, and the
second gives only what the profiler does not move: the device operations,
their count and their own durations. ``ctx.unit_s`` is the mean time of the
window's units before both stretches, untraced.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

#: the span the harness opens around each traced unit
UNIT = "portbench.unit"


# -- end to end: ``run`` is the harness's record of the window -----------------
def lanes_per_s(run) -> Optional[float]:
    """Lanes of every unit completed in the window over all its seconds."""
    return run.attempted / run.window_s if run.window_s > 0 and run.units else None


def unit_ms_p95(run) -> Optional[float]:
    """The 95th percentile (linear between ranks) of every unit's time."""
    return float(np.percentile(run.unit_ms, 95)) if run.unit_ms else None


def setup_s(run) -> Optional[float]:
    return run.setup_s


# -- per layer: ``ctx`` is the harness's record of the two stretches -----------
def span_ms(ctx, span: str) -> Optional[float]:
    """The device-clock time from entry to return of ``span``'s calls, a unit:
    its own work and any wait for the host inside it, not the wait for work
    queued before it."""
    calls = ctx.calls.get(span)
    if not calls or not ctx.span_units:
        return None
    return sum(c.ms for c in calls) / ctx.span_units


def rest_ms(ctx, span: str, inner) -> Optional[float]:
    """``span_ms`` of ``span`` less that of the spans ``inner`` called inside it."""
    outer = span_ms(ctx, span)
    if outer is None:
        return None
    return outer - sum(span_ms(ctx, s) or 0.0 for s in inner)


def roofline_pct(ctx, span: str, bound_s: Callable) -> Optional[float]:
    """``bound_s(call)``, the least time each traced call of ``span`` could
    take, summed over the device time of the operations launched under
    those calls, in percent."""
    spans = [s for s in ctx.trace.named(span)
             if ctx.window[0] <= s.start and s.end <= ctx.window[1]]
    calls = ctx.traced_calls.get(span, [])
    if not spans or len(spans) != len(calls):
        return None
    busy = sum(o.end - o.start for s in spans for o in ctx.trace.ops_under(s)) * 1e-6
    return 100.0 * sum(bound_s(c) for c in calls) / busy if busy > 0 else None


def device_ops(ctx) -> Optional[float]:
    """Device operations (kernels, copies, memsets) launched in the traced
    stretch, a unit."""
    if not ctx.units or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops_in(*ctx.window)) / len(ctx.units)


def busy_ms(ctx) -> Optional[float]:
    """Time in which some device operation runs (the union of the device
    intervals of the traced stretch), a unit."""
    lo, hi = ctx.window
    if hi <= lo or not ctx.trace.ops or not ctx.units:
        return None
    return 1e3 * sum(e - s for s, e in ctx.trace.busy(lo, hi)) * 1e-6 / len(ctx.units)


def idle_pct(ctx) -> Optional[float]:
    """Share of an untraced unit's time in which the device runs nothing:
    the device's busy time a unit (traced) against the unit's time (untraced)."""
    busy = busy_ms(ctx)
    if busy is None or not ctx.unit_s:
        return None
    return 100.0 * (1.0 - 1e-3 * busy / ctx.unit_s)
