"""Time-varying DCM planner: the ``TimeVaryingDCMPlanner`` capability.

Counterpart of ``blf_tpu/mpc/dcm_planner.py``; everything of it is ported.
The optimal-control transcription is solved by the batched SQP
(:mod:`blf_tpu_torch.mpc.sqp`), lanes on a leading axis. Formulation, as the
reference's:

- state ``x = (xi in R^3, omega)``: the 3-D divergent component of motion
  and the time-varying natural frequency;
- control ``u = (z in R^2, omega_dot)``: the ZMP/eCMP ground position and
  the omega rate;
- VRP ``v = (z_x, z_y, z_ground + g / omega^2)``;
- DCM flow ``xi' = alpha (xi - v)`` with ``alpha = omega - omega_dot / omega``,
  discretized exactly over each knot (ZOH on ``u``, alpha frozen):
  ``xi+ = v + e^(alpha dt) (xi - v)``; for omega_dot = 0 it is
  :func:`blf_tpu_torch.models.lipm.dcm_discrete_step`;
- inequalities: the per-knot support polygon ``A_k z <= b_k``, omega bounds,
  and ``omega_dot <= omega^2 - margin`` (alpha > 0);
- cost: ZMP tracking of the footstep reference, omega regularization to the
  nominal LIPM frequency, omega_dot smoothness, optional DCM-reference
  tracking, and a terminal residual pinning ``(xi_T, omega_T)`` to the
  capture state.

The plan data (references, polygons, goal) are shared by every lane; each
lane has its own initial DCM and omega. The parameters are cast to the
working dtype (that of ``zmp_ref``) and device before use.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from blf_tpu_torch.models.lipm import LIPMParams, lipm_omega
from blf_tpu_torch.mpc.sqp import SQPConfig, solve_trajopt

__all__ = [
    "DCMPlannerWeights",
    "DCMPlannerLimits",
    "DCMPlannerSolution",
    "plan_time_varying_dcm",
    "plan_time_varying_dcm_batch",
    "com_from_dcm_omega",
]


class DCMPlannerWeights(NamedTuple):
    zmp_tracking: float = 10.0
    omega_tracking: float = 1.0
    omega_dot: float = 1.0
    dcm_tracking: float = 0.0      # optional pull toward a seed DCM reference
    terminal_dcm: float = 100.0
    terminal_omega: float = 10.0


class DCMPlannerLimits(NamedTuple):
    omega_min: float = 0.5
    omega_max: float = 10.0
    alpha_margin: float = 0.1      # omega_dot <= omega^2 - margin


class DCMPlannerSolution(NamedTuple):
    dcm: torch.Tensor        # (..., T+1, 3)
    omega: torch.Tensor      # (..., T+1)
    zmp: torch.Tensor        # (..., T, 2)
    omega_dot: torch.Tensor  # (..., T)
    vrp: torch.Tensor        # (..., T, 3)
    cost: torch.Tensor       # (...,)
    max_violation: torch.Tensor
    converged: torch.Tensor


def _dcm_step(x, u, dt, gravity, z_ground):
    """Exact one-knot flow of ``xi' = alpha (xi - v)``, omega_dot ZOH;
    ``x`` (..., 4), ``u`` (..., 3)."""
    xi, omega = x[..., :3], x[..., 3:]
    zmp, omega_dot = u[..., :2], u[..., 2:]
    alpha = omega - omega_dot / omega
    vrp = torch.cat([zmp, z_ground + gravity / (omega * omega)], -1)
    xi_next = vrp + torch.exp(alpha * dt) * (xi - vrp)
    return torch.cat([xi_next, omega + dt * omega_dot], -1)


# The AL ladder starts soft (10 -> 1e5 over 5 rounds): a stiff start
# (penalty_init=100) diverges in float32 when the seed is far from feasible.
_SQP = SQPConfig(iterations=10, al_iterations=5, penalty_init=10.0)


def plan_time_varying_dcm_batch(
    params: LIPMParams,
    dt: float,
    dcm0: torch.Tensor,         # (B, 3) initial DCM of each lane (z component = xi_z)
    omega0: torch.Tensor,       # (B,) initial omega of each lane
    zmp_ref: torch.Tensor,      # (T, 2) footstep/ZMP reference
    poly_A: torch.Tensor,       # (T, M, 2) support polygon normals
    poly_b: torch.Tensor,       # (T, M) offsets (A z <= b)
    dcm_goal: torch.Tensor,     # (3,) terminal capture DCM
    *,
    dcm_ref: Optional[torch.Tensor] = None,  # (T+1, 3) optional seed
    weights: DCMPlannerWeights = DCMPlannerWeights(),
    limits: DCMPlannerLimits = DCMPlannerLimits(),
    z_ground: float = 0.0,
    sqp: SQPConfig = _SQP,
) -> DCMPlannerSolution:
    """Plan a T-knot time-varying DCM/omega/ZMP trajectory for every lane
    of ``dcm0`` / ``omega0`` (leading batch axes) against the shared plan
    data. Every field of the result carries the batch."""
    dtype, device = zmp_ref.dtype, zmp_ref.device
    T = zmp_ref.shape[0]
    params = LIPMParams(*(torch.as_tensor(p).to(device=device, dtype=dtype) for p in params))
    dcm_goal = dcm_goal.to(dtype)
    if dcm_ref is not None:
        dcm_ref = dcm_ref.to(dtype)
    g = params.gravity
    omega_nom = lipm_omega(params)
    w = weights
    sw_zmp, sw_om, sw_omd, sw_dcm, sw_tdcm, sw_tom = (
        math.sqrt(v) for v in (w.zmp_tracking, w.omega_tracking, w.omega_dot,
                               w.dcm_tracking, w.terminal_dcm, w.terminal_omega))

    def dynamics(x, u, k):
        return _dcm_step(x, u, dt, g, z_ground)

    def running_residuals(x, u, k):
        res = [sw_zmp * (u[..., :2] - zmp_ref[k]),
               sw_om * (x[..., 3:] - omega_nom),
               sw_omd * u[..., 2:]]
        if dcm_ref is not None:
            res.append(sw_dcm * (x[..., :3] - dcm_ref[k]))
        return torch.cat(res, -1)

    def terminal_residuals(x):
        return torch.cat([sw_tdcm * (x[..., :3] - dcm_goal),
                          sw_tom * (x[..., 3:] - omega_nom)], -1)

    def inequality(x, u, k):
        omega, omega_dot = x[..., 3:], u[..., 2:]
        poly = (poly_A[k] * u[..., None, :2]).sum(-1) - poly_b[k]
        bounds = torch.cat([limits.omega_min - omega, omega - limits.omega_max,
                            omega_dot - (omega * omega - limits.alpha_margin)], -1)
        return torch.cat([poly, bounds], -1)

    x0 = torch.cat([dcm0, omega0[..., None]], -1)
    us_init = torch.cat([zmp_ref, torch.zeros_like(zmp_ref[:, :1])], -1)
    sol = solve_trajopt(dynamics, running_residuals, terminal_residuals, x0,
                        us_init.expand(x0.shape[:-1] + us_init.shape),
                        inequality=inequality, config=sqp)
    omega_traj = sol.states[..., 3]
    vrp = torch.cat([sol.controls[..., :2],
                     (z_ground + g / omega_traj[..., :-1] ** 2)[..., None]], -1)
    return DCMPlannerSolution(
        dcm=sol.states[..., :3], omega=omega_traj, zmp=sol.controls[..., :2],
        omega_dot=sol.controls[..., 2], vrp=vrp, cost=sol.cost,
        max_violation=sol.max_violation, converged=sol.converged)


def plan_time_varying_dcm(params: LIPMParams, dt: float, dcm0, omega0, zmp_ref, poly_A,
                          poly_b, dcm_goal, **kwargs) -> DCMPlannerSolution:
    """One plan: ``dcm0`` (3,), ``omega0`` a scalar; the batch form at B = 1,
    squeezed."""
    dtype, device = zmp_ref.dtype, zmp_ref.device
    dcm0 = torch.as_tensor(dcm0, dtype=dtype, device=device)[None]
    omega0 = torch.as_tensor(omega0, dtype=dtype, device=device).reshape(1)
    sol = plan_time_varying_dcm_batch(params, dt, dcm0, omega0, zmp_ref, poly_A, poly_b,
                                      dcm_goal, **kwargs)
    return DCMPlannerSolution(*(t[0] for t in sol))


def com_from_dcm_omega(com0, dcm, omega, dt):
    """Integrate the stable CoM flow ``c' = omega (xi - c)`` along a planned
    ``(xi, omega)`` trajectory (exact per-knot exponential, xi and omega
    frozen). ``com0`` (..., 3), ``dcm`` (..., T+1, 3), ``omega`` (..., T+1)
    -> (..., T+1, 3)."""
    T = dcm.shape[-2] - 1
    c = com0 + 0.0 * dcm[..., 0, :] + 0.0 * omega[..., 0, None]
    cs = [c]
    for k in range(T):
        xi = dcm[..., k, :]
        decay = torch.exp(-omega[..., k] * dt)[..., None]
        c = xi + decay * (c - xi)
        cs.append(c)
    return torch.stack(cs, -2)
