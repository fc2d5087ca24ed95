"""Fleet-wide solver statistics.

Counterpart of ``blf_tpu/parallel/collectives.py`` (``FleetStats``,
``reduce_fleet_stats``). On one device the reference's ``psum``/``pmax`` over
the data axis are plain reductions over the batch.

Not yet ported: ``psum_tree``/``pmax_tree`` and every reduction across
devices (``torch.distributed``), which come with the multi-device slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FleetStats", "reduce_fleet_stats"]


class FleetStats(NamedTuple):
    """Global solver statistics for one control tick (0-dim tensors)."""

    num_scenarios: torch.Tensor     # total lanes
    num_converged: torch.Tensor     # lanes with converged QPs
    max_primal_residual: torch.Tensor
    max_dual_residual: torch.Tensor
    mean_objective: torch.Tensor


def reduce_fleet_stats(qp_solution) -> FleetStats:
    """Reduce a per-lane :class:`blf_tpu_torch.mpc.qp.QPSolution` to fleet
    statistics. Counts are float32, as in the reference."""
    conv = qp_solution.converged
    n = torch.full((), float(conv.numel()), dtype=torch.float32,
                   device=conv.device)
    return FleetStats(
        num_scenarios=n,
        num_converged=conv.to(torch.float32).sum(),
        max_primal_residual=qp_solution.primal_residual.max(),
        max_dual_residual=qp_solution.dual_residual.max(),
        mean_objective=qp_solution.objective.sum() / n,
    )
