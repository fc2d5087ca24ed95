"""The benchmark's spans around calls into the program's layers.

A per-layer metric's file (``metrics/<name>.py``) names the functions it
needs a span around in ``SPANS``, each ``"<module>:<attribute>"``; the
harness wraps the union of the cell's metrics' spans for the stretches of a
``--trace 1`` run that read them, and only then. A wrapped call opens a
``record_function`` span named by its target (read from the profiler's
trace) and is marked on the device's clock at its entry and return, with the
shapes of its tensor arguments and its whole-number keyword arguments.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Dict, Iterable, List, NamedTuple

import torch

__all__ = ["Clock", "Call", "Timed", "patched", "timed"]


class Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else 1e3 * (b - a)


class Call(NamedTuple):
    shapes: tuple        # each positional argument's shape, or None for a non-tensor
    ints: dict           # the keyword arguments that are whole numbers
    marks: tuple         # the clock's marks at entry and at return


class Timed(NamedTuple):
    shapes: tuple
    ints: dict
    ms: float            # from entry to return on the clock


def timed(calls: Dict[str, List[Call]], clock: Clock) -> Dict[str, List[Timed]]:
    """Each call's time between its marks; after the device has finished them."""
    return {t: [Timed(c.shapes, c.ints, clock.ms(*c.marks)) for c in cs]
            for t, cs in calls.items()}


def _describe(args, kwargs):
    shapes = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else None for a in args)
    ints = {k: v for k, v in kwargs.items() if isinstance(v, int) and not isinstance(v, bool)}
    return shapes, ints


@contextlib.contextmanager
def patched(targets: Iterable[str], clock: Clock):
    """Wrap each ``"<module>:<attribute>"`` of ``targets``; yields the calls
    seen, ``{target: [Call, ...]}``, and restores the originals on exit."""
    calls: Dict[str, List[Call]] = {}
    saved = []
    try:
        for target in sorted(set(targets)):
            module_name, attr = target.split(":")
            module = importlib.import_module(module_name)
            original = getattr(module, attr)
            calls[target] = []

            def wrapper(*args, _original=original, _target=target, **kwargs):
                start = clock.mark()
                with torch.profiler.record_function(_target):
                    out = _original(*args, **kwargs)
                calls[_target].append(Call(*_describe(args, kwargs), (start, clock.mark())))
                return out

            saved.append((module, attr, original))
            setattr(module, attr, wrapper)
        yield calls
    finally:
        for module, attr, original in reversed(saved):
            setattr(module, attr, original)
