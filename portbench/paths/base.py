"""What every program path's driver shares: the sample of units that the
reference checks.

A driver (one module under ``paths/`` a program path, named by a
configuration's ``"path"``) subclasses :class:`Driver`: its constructor
makes the inputs from the seed and builds the program's objects, ``unit()``
runs one unit of work (a tick, a plan) through the timed path up to the
read-back a caller waits for, and ``compare(precision)`` judges the sampled
units against the plain reference.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Dict, List, Tuple

import torch

__all__ = ["Driver"]


class Driver:
    """One program path under one configuration and traffic mix.

    ``lanes_per_unit`` lane-solves or lane-plans make one unit (of this
    rank, where a ``world`` of ranks runs the cell). The sample:
    the first warm-up unit (the cold start) and, of the window's units, a
    uniform sample of ``sampled_units`` drawn with the seed (reservoir
    sampling, decided on the host) plus the last. A sampled unit is kept by
    reference to the program's own tensors, so sampling adds no device work
    to the window."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device,
                 world=None):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.world = world
        self.lanes_per_unit = int(traffic["lanes"]) * int(traffic.get("ensemble", 1))
        self._rng = random.Random(int(seed))
        self._k = int(traffic["sampled_units"])
        self.cold = None
        self.sample: List[object] = []
        self.last = None
        self._seen = 0
        self._recent = deque(maxlen=self._k + 2)
        self._warming = True

    # -- sampling -------------------------------------------------------------
    def _record(self, rec) -> None:
        if self._warming:
            if self.cold is None:
                self.cold = rec
            # keep as many records alive as the window will, so that the
            # allocator holds their blocks before the window opens
            self._recent.append(rec)
            return
        self._seen += 1
        self.last = rec
        if len(self.sample) < self._k:
            self.sample.append(rec)
        else:
            j = self._rng.randrange(self._seen)
            if j < self._k:
                self.sample[j] = rec

    def begin_window(self) -> None:
        self._warming = False
        self._recent.clear()

    def checked(self) -> List[object]:
        """The window's sampled units and its last, each once."""
        out = list(self.sample)
        if self.last is not None and all(self.last is not r for r in out):
            out.append(self.last)
        return out

    # -- what a path defines --------------------------------------------------
    def warm(self) -> None:
        for _ in range(int(self.traffic["warmup_units"])):
            self.unit()

    def unit(self) -> Tuple[int, int]:
        """Run one unit; return (lanes attempted, lanes failed)."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's state but the sampled units."""

    def compare(self, precision: str = "float64") -> Dict[str, float]:
        """The compared numbers of the sampled units: the program's against
        the reference with ``precision="float64"``; with ``"bfloat16"`` the
        control's (the reference in the program's place, one precision
        lower) against the reference."""
        raise NotImplementedError
