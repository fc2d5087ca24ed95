"""Per-lane status codes: failure handling as data, not exceptions.

Counterpart of ``blf_tpu/utils/status.py``; everything of it is ported.
:class:`SolverStatus` is a copy with the same integer codes, so a status
array means the same on both sides.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Dict

import torch

from blf_tpu_torch.utils.containers import tree_map

__all__ = ["SolverStatus", "classify_qp", "nan_quarantine", "status_counts"]


class SolverStatus(IntEnum):
    """Per-lane solver outcome; the codes are ordered by severity."""

    CONVERGED = 0
    MAX_ITERATIONS = 1
    NUMERICAL_ERROR = 2      # NaN/Inf anywhere in the lane's solution


def classify_qp(qp_solution) -> torch.Tensor:
    """Map a :class:`blf_tpu_torch.mpc.qp.QPSolution` to per-lane int32 codes."""
    bad = ~(
        torch.isfinite(qp_solution.x).all(dim=-1)
        & torch.isfinite(qp_solution.primal_residual)
        & torch.isfinite(qp_solution.dual_residual)
    )
    status = torch.where(
        qp_solution.converged,
        int(SolverStatus.CONVERGED), int(SolverStatus.MAX_ITERATIONS))
    status = torch.where(bad, int(SolverStatus.NUMERICAL_ERROR), status)
    return status.to(torch.int32)


def nan_quarantine(state_tree, status: torch.Tensor, reset_tree):
    """Replace the lanes flagged NUMERICAL_ERROR by their reset values.

    The reset itself is sanitized (non-finite reset entries become 0), so
    quarantine always produces a finite lane even when the last-good state
    was already poisoned.
    """
    bad = status == int(SolverStatus.NUMERICAL_ERROR)

    def fix(cur, rst):
        mask = bad.reshape(bad.shape + (1,) * (cur.dim() - bad.dim()))
        rst = torch.as_tensor(rst, device=cur.device).broadcast_to(cur.shape)
        if rst.dtype.is_floating_point:
            rst = torch.where(torch.isfinite(rst), rst, torch.zeros_like(rst))
        return torch.where(mask, rst.to(cur.dtype), cur)

    return tree_map(fix, state_tree, reset_tree)


def status_counts(status: torch.Tensor) -> Dict[str, int]:
    """Host-side summary for telemetry and logs (one device-to-host copy)."""
    host = status.detach().cpu()
    return {s.name.lower(): int((host == int(s)).sum()) for s in SolverStatus}
