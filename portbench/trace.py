"""Reading a profiler trace: spans, device operations, the union of device
intervals, self times and the ``breakdown``.

Takes the events of ``torch.profiler``'s Chrome-trace export (``ph: "X"``
events, times in microseconds). Host spans are the ``user_annotation``
events (the benchmark's ``record_function`` spans) and ``cpu_op`` events;
a device operation (``kernel``, ``gpu_memcpy``, ``gpu_memset``) belongs to
every host span that contains the runtime or driver call that launched it,
matched by its ``correlation``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

__all__ = ["Span", "DeviceOp", "Trace", "union", "length", "gaps"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CATS = ("user_annotation", "cpu_op")

Interval = Tuple[float, float]


class Span(NamedTuple):
    name: str
    start: float
    end: float
    tid: object
    user: bool            # a record_function span (not a cpu_op)


class DeviceOp(NamedTuple):
    name: str
    start: float
    end: float
    launch: Optional[float]     # host time of its launch call, if matched
    tid: object


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Merged, sorted, disjoint intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in union(intervals))


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that the disjoint sorted ``busy`` leaves."""
    out, t = [], lo
    for s, e in clip(busy, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


class Trace:
    """The parsed events of one traced stretch."""

    def __init__(self, events: List[dict]):
        launches: Dict[object, Tuple[float, object]] = {}
        self.spans: List[Span] = []
        ops = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in LAUNCH_CATS and "correlation" in args:
                launches[args["correlation"]] = (ts, ev.get("tid"))
            elif cat in SPAN_CATS:
                self.spans.append(Span(ev.get("name", ""), ts, ts + dur, ev.get("tid"),
                                       cat == "user_annotation"))
            elif cat in DEVICE_CATS:
                ops.append((ev.get("name", ""), ts, ts + dur, args.get("correlation")))
        self.ops: List[DeviceOp] = []
        for name, s, e, corr in ops:
            launch, tid = launches.get(corr, (None, None))
            self.ops.append(DeviceOp(name, s, e, launch, tid))
        self.ops.sort(key=lambda o: o.start)
        self.unmatched = sum(o.launch is None for o in self.ops)

    # -- spans ----------------------------------------------------------------
    def named(self, name: str) -> List[Span]:
        return sorted((s for s in self.spans if s.user and s.name == name),
                      key=lambda s: s.start)

    def window(self, unit_span: str) -> Optional[Interval]:
        """From the first ``unit_span``'s start to the last one's end."""
        units = self.named(unit_span)
        if not units:
            return None
        return units[0].start, max(s.end for s in units)

    def ops_under(self, span: Span) -> List[DeviceOp]:
        """Device operations whose launch lies inside ``span`` on its thread."""
        return [o for o in self.ops if o.launch is not None and o.tid == span.tid
                and span.start <= o.launch <= span.end]

    def device_extent(self, span: Span) -> Optional[Interval]:
        """From the first device operation launched under ``span`` to the
        last one's end."""
        ops = self.ops_under(span)
        if not ops:
            return None
        return min(o.start for o in ops), max(o.end for o in ops)

    def self_time(self, span: Span, children: Iterable[str]) -> float:
        """``span``'s duration less the part that child spans of the given
        names (on its thread, inside it) cover."""
        names = set(children)
        inner = [(max(c.start, span.start), min(c.end, span.end)) for c in self.spans
                 if c.user and c.name in names and c.tid == span.tid
                 and c.start < span.end and c.end > span.start and c is not span]
        return (span.end - span.start) - length(inner)

    # -- the device -----------------------------------------------------------
    def busy(self, lo: float, hi: float) -> List[Interval]:
        return clip(union((o.start, o.end) for o in self.ops), lo, hi)

    def ops_in(self, lo: float, hi: float) -> List[DeviceOp]:
        """Device operations launched inside [lo, hi] (or, unmatched, that
        start inside it)."""
        return [o for o in self.ops
                if lo <= (o.launch if o.launch is not None else o.start) <= hi]

    def breakdown(self, stretches: List[Interval], tid, top: int = 10) -> dict:
        """The device operations launched in ``stretches`` that took most
        time, and the longest idle gaps inside them, summed by the innermost
        host span of thread ``tid`` open at each gap's middle (spans on one
        thread nest: it is the latest-starting one that has not ended)."""
        by_op = defaultdict(float)
        for lo, hi in stretches:
            for o in self.ops_in(lo, hi):
                by_op[o.name[:160]] += (o.end - o.start) * 1e-6
        host = sorted((s for s in self.spans if s.tid == tid), key=lambda s: s.start)
        starts = [s.start for s in host]
        by_host = defaultdict(float)
        for lo, hi in stretches:
            for s, e in gaps(self.busy(lo, hi), lo, hi):
                mid = 0.5 * (s + e)
                i = bisect.bisect_right(starts, mid) - 1
                while i >= 0 and host[i].end < mid:
                    i -= 1
                name = host[i].name if i >= 0 else "(no host span)"
                by_host[name[:160]] += (e - s) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
