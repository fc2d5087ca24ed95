"""Decision-variable registry: names -> slices of a flat optimization vector.

Counterpart of ``blf_tpu/planners/variables.py``; everything of it is ported
(host code: name -> (offset, size) bookkeeping, plus pack/unpack helpers so
transcription code can move between a dict of named tensors and the flat
vector a QP solver sees).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

__all__ = ["IndexRange", "VariablesHandler"]


class IndexRange(NamedTuple):
    """(offset, size) pair."""

    offset: int
    size: int

    @property
    def slice(self) -> slice:
        return slice(self.offset, self.offset + self.size)


class VariablesHandler:
    """Stacks named variables into one flat vector.

    ``add_variable`` rejects duplicates and ``get_variable`` of an unknown
    name raises.
    """

    def __init__(self):
        self._variables: Dict[str, IndexRange] = {}
        self._num_variables = 0

    def add_variable(self, name: str, size: int) -> IndexRange:
        if name in self._variables:
            raise ValueError(
                f"[VariablesHandler::add_variable] variable {name!r} already exists"
            )
        if size <= 0:
            raise ValueError(f"variable {name!r} must have positive size")
        rng = IndexRange(self._num_variables, int(size))
        self._variables[name] = rng
        self._num_variables += int(size)
        return rng

    def get_variable(self, name: str) -> IndexRange:
        if name not in self._variables:
            raise KeyError(f"[VariablesHandler::get_variable] unknown variable {name!r}")
        return self._variables[name]

    def has_variable(self, name: str) -> bool:
        return name in self._variables

    @property
    def num_variables(self) -> int:
        return self._num_variables

    def names(self):
        return list(self._variables)

    # -- flat-vector helpers ------------------------------------------------
    def extract(self, name: str, flat: torch.Tensor) -> torch.Tensor:
        """Named view into the trailing axis of a (batched) flat vector."""
        r = self.get_variable(name)
        return flat[..., r.offset : r.offset + r.size]

    def pack(self, values: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Assemble the flat vector from named parts (all must be present)."""
        missing = set(self._variables) - set(values)
        if missing:
            raise KeyError(f"missing variables in pack(): {sorted(missing)}")
        parts = [torch.as_tensor(values[n]) for n in self._variables]
        return torch.cat(parts, dim=-1)

    def unpack(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: self.extract(n, flat) for n in self._variables}
