"""Recursive least squares with forgetting factor, as a batched filter.

Counterpart of ``blf_tpu/estimators/rls.py``; everything of it is ported. The
update is a pure step function

    ``state' = rls_step(params, state, regressor, measurement)``

that broadcasts over leading batch axes (a fleet of estimators, one per MPC
scenario). The ``m x m`` innovation system is solved with the unrolled
small-PSD Cholesky of :func:`blf_tpu_torch.ops.linalg.solve_psd`.
``lax.scan`` over a measurement stream becomes a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from blf_tpu_torch.ops.linalg import solve_psd
from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype

__all__ = ["RLSParams", "RLSState", "init_from_handler", "rls_step", "rls_scan"]


class RLSParams(NamedTuple):
    """Static filter parameters."""

    lam: torch.Tensor                     # forgetting factor in (0, 1]
    measurement_covariance: torch.Tensor  # (m, m) noise covariance R


class RLSState(NamedTuple):
    """Filter state: parameter estimate and its covariance."""

    theta: torch.Tensor       # (..., p)
    covariance: torch.Tensor  # (..., p, p)


def init_from_handler(handler, *, device=None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Tuple[RLSParams, RLSState]:
    """Build (params, state) from a parameters handler.

    ``handler`` is duck-typed: ``get_parameter(name, type)`` and
    ``get_array(name)``, with the reference's key names ``lambda``,
    ``measurement_covariance`` (diagonal), ``state``, ``state_covariance``
    (diagonal).
    """
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    lam = as_t(handler.get_parameter("lambda", float))
    meas_cov = torch.diag(as_t(handler.get_array("measurement_covariance")))
    theta = as_t(handler.get_array("state"))
    cov = torch.diag(as_t(handler.get_array("state_covariance")))
    return RLSParams(lam, meas_cov), RLSState(theta, cov)


@f32_matmuls
def rls_step(params: RLSParams, state: RLSState, regressor: torch.Tensor,
             measurement: torch.Tensor) -> RLSState:
    """One RLS/Kalman update:

    ``K = P A^T (lam R + A P A^T)^-1``; ``theta <- theta + K (y - A theta)``;
    ``P <- (P - K A P)/lam``.

    Shapes: ``regressor`` ``(..., m, p)``, ``measurement`` ``(..., m)``;
    broadcasts over leading batch axes.
    """
    lam, R = params.lam, params.measurement_covariance
    theta, P = state.theta, state.covariance

    AP = regressor @ P                                            # (..., m, p)
    S = lam * R + AP @ regressor.transpose(-1, -2)                # (..., m, m)
    # K = P A^T S^-1  <=>  K^T = S^-1 A P (S symmetric PSD)
    K = solve_psd(S, AP).transpose(-1, -2)                        # (..., p, m)

    innovation = measurement - (regressor @ theta[..., None])[..., 0]
    theta_next = theta + (K @ innovation[..., None])[..., 0]
    P_next = (P - K @ AP) / lam
    # re-symmetrize: lam < 1 and/or f32 batches need P to stay symmetric PSD
    P_next = 0.5 * (P_next + P_next.transpose(-1, -2))
    return RLSState(theta_next, P_next)


def rls_scan(params: RLSParams, state0: RLSState, regressors: torch.Tensor,
             measurements: torch.Tensor, save_trajectory: bool = False):
    """Run the filter over a whole measurement stream.

    ``regressors``: ``(T, ..., m, p)``; ``measurements``: ``(T, ..., m)``.
    Returns the final state, and with ``save_trajectory`` also the
    ``(T, ..., p)`` estimates.
    """
    state = state0
    thetas = []
    for A, y in zip(regressors, measurements):
        state = rls_step(params, state, A, y)
        if save_trajectory:
            thetas.append(state.theta)
    if save_trajectory:
        return state, torch.stack(thetas, dim=0)
    return state
