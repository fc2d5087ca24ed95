"""The arithmetic of the per-layer metrics that read the program's own spans
(``blf_tpu_torch.utils.profiling.trace``: ``fleet.tick``, ``qp.boundary``,
``sync.eigh``, ... as each program module's ``SPANS`` documents them).

A metric file under ``metrics/`` that reads them sets ``SPANS = []`` (it
needs nothing of the program rebound) and names the program's spans it reads
in ``PROGRAM_SPANS``. It reads them in the profiled stretch of a ``--trace
1`` run (``ctx.trace``, inside ``ctx.window``), and only what the profiler
does not move: device operations and their device durations, counted under
the spans whose host interval holds their launch (``Trace.ops_under``), and
the spans themselves, each a traced unit (``len(ctx.units)``). A program
without these spans gives nothing to read: the reader returns None and the
harness leaves the metric out.
"""

from __future__ import annotations

import fnmatch
from typing import Iterable, List, Optional

from portbench.trace import DeviceOp, Span, length

__all__ = ["spans", "ops_under", "busy_ms", "ops", "count"]


def spans(ctx, names: Iterable[str]) -> List[Span]:
    """The program's spans inside the profiled stretch whose names match one
    of ``names`` (``fnmatch`` patterns: ``"sync.*"``)."""
    lo, hi = ctx.window
    names = list(names)
    return [s for s in ctx.trace.spans
            if s.user and lo <= s.start and s.end <= hi
            and any(fnmatch.fnmatchcase(s.name, n) for n in names)]


def ops_under(ctx, names: Iterable[str]) -> Optional[List[DeviceOp]]:
    """The device operations launched under any span of ``names``, each once;
    None where the stretch holds no such span, or the trace no device
    operation at all (a profiler that saw only the host)."""
    found = spans(ctx, names)
    if not found or not ctx.units or not ctx.trace.ops:
        return None
    return list({o for s in found for o in ctx.trace.ops_under(s)})


def busy_ms(ctx, names: Iterable[str]) -> Optional[float]:
    """Milliseconds in which a device operation launched under the spans
    ``names`` runs (the union of their device intervals), a unit."""
    found = ops_under(ctx, names)
    if found is None:
        return None
    return 1e-3 * length((o.start, o.end) for o in found) / len(ctx.units)


def ops(ctx, names: Iterable[str]) -> Optional[float]:
    """Device operations launched under the spans ``names``, a unit."""
    found = ops_under(ctx, names)
    return None if found is None else len(found) / len(ctx.units)


def count(ctx, pattern: str, root: str) -> Optional[float]:
    """Spans whose names match ``pattern`` inside the program's ``root``
    spans, a unit; None where the stretch holds no ``root`` span (a program
    without spans), so that a program with none of ``pattern`` reads 0."""
    roots = spans(ctx, [root])
    if not roots or not ctx.units:
        return None
    inner = [s for s in spans(ctx, [pattern])
             if any(r.tid == s.tid and r.start <= s.start and s.end <= r.end for r in roots)]
    return len(inner) / len(ctx.units)
