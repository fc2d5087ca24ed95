"""Linear Inverted Pendulum + Divergent Component of Motion models.

Counterpart of ``blf_tpu/models/lipm.py``. Continuous dynamics:

- LIPM: ``x'' = w^2 (x - z)`` with ``w = sqrt(g / z_c)``, ``x`` the CoM
  ground projection and ``z`` the ZMP.
- DCM: ``xi = x + x'/w`` splits the LIPM into the unstable flow
  ``xi' = w (xi - z)`` and the stable CoM tracker ``x' = w (xi - x)``.

Everything is closed-form exponential (exact zero-order-hold discretisation),
batched over leading axes and dtype-generic. Time loops that are
``lax.scan`` in the reference are Python loops here. Everything of the
reference module is ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "LIPMParams",
    "lipm_omega",
    "dcm_dynamics",
    "com_dynamics",
    "dcm_discrete_step",
    "com_discrete_step",
    "dcm_backward_recursion",
    "dcm_reference_trajectory",
    "com_trajectory_from_dcm",
]


class LIPMParams(NamedTuple):
    """Static pendulum parameters (0-dim tensors)."""

    com_height: torch.Tensor  # z_c [m]
    gravity: torch.Tensor     # g [m/s^2]


def lipm_omega(params: LIPMParams) -> torch.Tensor:
    """Natural frequency ``w = sqrt(g / z_c)``."""
    return torch.sqrt(params.gravity / params.com_height)


def dcm_dynamics(params: LIPMParams, dcm, zmp):
    """``xi' = w (xi - z)`` (unstable first-order flow)."""
    return lipm_omega(params) * (dcm - zmp)


def com_dynamics(params: LIPMParams, com, dcm):
    """``x' = w (xi - x)`` (stable first-order tracker)."""
    return lipm_omega(params) * (dcm - com)


def dcm_discrete_step(params: LIPMParams, dcm, zmp, dt):
    """Exact ZOH step: ``xi+ = z + e^{w dt} (xi - z)`` (z constant over dt)."""
    a = torch.exp(lipm_omega(params) * dt)
    return zmp + a * (dcm - zmp)


def com_discrete_step(params: LIPMParams, com, dcm, zmp, dt):
    """Exact CoM step under the coupled flow with constant z over dt:
    ``x(t) = z + e^{-wt}(x0 - z) + (xi0 - z)(e^{wt} - e^{-wt})/2``."""
    w = lipm_omega(params)
    em, ep = torch.exp(-w * dt), torch.exp(w * dt)
    return zmp + em * (com - zmp) + 0.5 * (ep - em) * (dcm - zmp)


def dcm_backward_recursion(params: LIPMParams, zmp_knots, dcm_final, dt):
    """DCM boundary recursion: per-knot ZMP plan ``z_k`` ``(T, 2)`` and
    terminal ``xi_T`` give the reference ``xi_k`` ``(T+1, 2)`` with
    ``xi_k = z_k + e^{-w dt}(xi_{k+1} - z_k)``."""
    a = torch.exp(-lipm_omega(params) * dt)
    xi = dcm_final
    xis = [dcm_final]
    for k in range(zmp_knots.shape[0] - 1, -1, -1):
        z_k = zmp_knots[k]
        xi = z_k + a * (xi - z_k)
        xis.append(xi)
    return torch.stack(xis[::-1], dim=0)


def dcm_reference_trajectory(params: LIPMParams, footholds, durations, dt):
    """Piecewise-constant-ZMP reference: ``footholds`` ``(S, 2)`` with per-step
    ``durations`` ``(S,)`` (seconds, multiples of dt). Returns (zmp_knots
    ``(T, 2)``, dcm_ref ``(T+1, 2)``) with the DCM ending on the final
    foothold."""
    seconds = torch.as_tensor(durations, dtype=torch.float64, device=footholds.device)
    reps = torch.round(seconds / dt).long()
    zmp = torch.repeat_interleave(footholds, reps, dim=0)
    return zmp, dcm_backward_recursion(params, zmp, footholds[-1], dt)


def com_trajectory_from_dcm(params: LIPMParams, com0, dcm_traj, zmp_knots, dt):
    """Integrate the stable CoM flow exactly along a DCM/ZMP trajectory.

    ``dcm_traj``: (..., T+1, 2); ``zmp_knots``: (..., T, 2) -> CoM (..., T+1, 2).
    Batch axes allowed (time is looped, batch rides along).
    """
    T = zmp_knots.shape[-2]
    x = com0 + 0 * dcm_traj[..., 0, :] + 0 * zmp_knots[..., 0, :]
    xs = [x]
    for k in range(T):
        x = com_discrete_step(params, x, dcm_traj[..., k, :],
                              zmp_knots[..., k, :], dt)
        xs.append(x)
    return torch.stack(xs, dim=-2)
