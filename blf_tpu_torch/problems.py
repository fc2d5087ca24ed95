"""Problem instances of the fleet tick, made with numpy from a seed.

Counterparts: ``_example_problem`` of ``__graft_entry__.py`` (a four-step
walking reference) and the stationary push-recovery workload that
``bench.py`` builds inline (time-invariant receding horizon, so the
warm-started steady state is the production workload). Inputs are drawn with
``numpy.random.default_rng(seed)``, so the JAX package and the port can be
fed the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from blf_tpu_torch.models.lipm import LIPMParams, dcm_backward_recursion
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype

__all__ = ["example_problem", "PushRecoveryProblem", "stationary_push_recovery"]

_BOX = [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]


def _lipm(device, dtype) -> LIPMParams:
    return LIPMParams(torch.tensor(0.9, dtype=dtype, device=device),
                      torch.tensor(9.81, dtype=dtype, device=device))


def example_problem(batch: int, horizon: int, *, seed: int = 0, device=None,
                    dtype: Optional[torch.dtype] = None):
    """``(params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b)``: a four-step
    walking reference with per-knot box polygons around the footholds and
    ``batch`` perturbed initial DCMs."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    params = _lipm(device, dtype)
    dt = 0.1
    steps = np.array([[0.0, -0.1], [0.2, 0.1], [0.4, -0.1], [0.6, 0.1]])
    reps = horizon // 4
    zmp_ref = as_t(np.repeat(steps, reps, axis=0)[:horizon])
    dcm_ref = dcm_backward_recursion(params, zmp_ref, as_t(steps[-1]), dt)
    poly_A = as_t(_BOX).repeat(horizon, 1, 1)
    poly_b = torch.stack(
        [zmp_ref[:, 0] + 0.07, -(zmp_ref[:, 0] - 0.07),
         zmp_ref[:, 1] + 0.04, -(zmp_ref[:, 1] - 0.04)], dim=-1)
    rng = np.random.default_rng(seed)
    dcm0 = as_t(np.array([0.05, -0.08]) + rng.uniform(-0.02, 0.02, (batch, 2)))
    return params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b


class PushRecoveryProblem(NamedTuple):
    """Inputs of the stationary push-recovery fleet tick."""

    params: LIPMParams
    dt: float
    dcm_ref: torch.Tensor      # (N+1, 2)
    zmp_ref: torch.Tensor      # (N, 2)
    poly_A: torch.Tensor       # (N, 4, 2)
    poly_b: torch.Tensor       # (N, 4)
    dcm0: torch.Tensor         # (2,) initial DCM of every lane
    com0: torch.Tensor         # (2,)
    disturbance: torch.Tensor  # (B, 1, 2) per-lane push, N(0, 0.004)
    num_constraints: int       # 2N + 4N rows of the transcription


def stationary_push_recovery(batch: int, horizon: int, *, seed: int = 0,
                             device=None, dtype: Optional[torch.dtype] = None
                             ) -> PushRecoveryProblem:
    """The fleet workload: every lane stands on one stance (references at the
    origin, a 0.2 m x 0.12 m support box), starts at DCM = CoM =
    (0.01, -0.01) and is pushed by its own draw of N(0, 0.004) each tick."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    start = as_t([0.01, -0.01])
    return PushRecoveryProblem(
        params=_lipm(device, dtype),
        dt=0.1,
        dcm_ref=torch.zeros((horizon + 1, 2), dtype=dtype, device=device),
        zmp_ref=torch.zeros((horizon, 2), dtype=dtype, device=device),
        poly_A=as_t(_BOX).repeat(horizon, 1, 1),
        poly_b=as_t([0.1, 0.1, 0.06, 0.06]).repeat(horizon, 1),
        dcm0=start,
        com0=start.clone(),
        disturbance=as_t(rng.normal(0, 0.004, (batch, 1, 2))),
        num_constraints=2 * horizon + 4 * horizon,
    )
