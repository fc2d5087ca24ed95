"""The MPC fleet tick: the framework's "training step" equivalent.

Counterpart of ``blf_tpu/parallel/sweep.py``. One control tick for a fleet
of push-recovery scenarios, as a plain batched function on one device:

    warm-started batched DCM-MPC solve -> fleet statistics -> state advance
    under the consensus plan + disturbance -> per-lane RLS update of a
    ZMP-offset disturbance estimate -> per-lane status + NaN quarantine.

The reference expresses the tick as a ``shard_map`` program over a
``(data, model)`` mesh, where the model axis carries a disturbance ensemble
of ``K`` push realizations per scenario. The ensemble axis stays in the
shapes here (``disturbance`` is ``(B, K, 2)``); with one device the
``pmean``/``pmax`` over it are identities, and only ``K == 1`` is accepted.

Not yet ported: ``K > 1`` ensembles and the data-parallel mesh (ROADMAP.md
4.5, multi-device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from blf_tpu_torch.estimators.rls import RLSParams, RLSState, rls_step
from blf_tpu_torch.models.lipm import LIPMParams, com_discrete_step, lipm_omega
from blf_tpu_torch.mpc.dcm import DCMWeights, solve_dcm_mpc
from blf_tpu_torch.parallel.collectives import FleetStats, reduce_fleet_stats
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype
from blf_tpu_torch.utils.status import SolverStatus, classify_qp, nan_quarantine

__all__ = ["FleetState", "TickResult", "make_fleet_step", "init_fleet"]


class FleetState(NamedTuple):
    """Per-scenario persistent state, leading axis = fleet batch."""

    dcm: torch.Tensor           # (B, 2)
    com: torch.Tensor           # (B, 2)
    warm_zmp: torch.Tensor      # (B, N, 2) previous plan (primal warm start)
    warm_y: torch.Tensor        # (B, M) previous duals
    offset_theta: torch.Tensor  # (B, 2) RLS estimate of the ZMP disturbance offset
    offset_cov: torch.Tensor    # (B, 2, 2)
    warm_s: torch.Tensor        # (B, 1) adapted per-lane ADMM rho multiplier


class TickResult(NamedTuple):
    stats: FleetStats
    worst_margin: torch.Tensor     # scalar: worst constraint margin
    consensus_zmp0: torch.Tensor   # (B, 2) first-knot consensus plan
    status: torch.Tensor           # (B,) int32 per-lane SolverStatus
    num_quarantined: torch.Tensor  # scalar: NUMERICAL_ERROR lanes this tick


def init_fleet(batch: int, horizon: int, num_constraints: int, dcm0, com0, *,
               device=None, dtype: Optional[torch.dtype] = None) -> FleetState:
    """Fleet state with zeroed warm starts and a fresh offset estimator."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    new = dict(dtype=dtype, device=device)
    dcm0 = torch.as_tensor(dcm0, **new).broadcast_to((batch, 2)).clone()
    com0 = torch.as_tensor(com0, **new).broadcast_to((batch, 2)).clone()
    return FleetState(
        dcm=dcm0,
        com=com0,
        warm_zmp=torch.zeros((batch, horizon, 2), **new),
        warm_y=torch.zeros((batch, num_constraints), **new),
        offset_theta=torch.zeros((batch, 2), **new),
        offset_cov=(torch.eye(2, **new) * 10.0).broadcast_to((batch, 2, 2)).clone(),
        warm_s=torch.ones((batch, 1), **new),
    )


def make_fleet_step(
    params: LIPMParams,
    dt: float,
    weights: Optional[DCMWeights] = None,
    iterations: int = 200,
    rls_lambda: float = 0.98,
    meas_noise: float = 1e-4,
    *,
    device=None,
    **qp_kwargs,
):
    """Build the tick function.

    Returns ``step(state, disturbance, dcm_ref, zmp_ref, poly_A, poly_b)
    -> (FleetState, TickResult)`` where ``disturbance`` is ``(B, K, 2)`` with
    ``K == 1`` (one push realization per scenario). Extra ``qp_kwargs`` (e.g.
    ``backend="cuda"``, ``"cuda_split"`` or ``"cuda_delta"`` (``bench.py``'s
    mode, the reference's ``"pallas"``), ``check_every``, ``polish_iters``)
    pass through to
    :func:`blf_tpu_torch.mpc.qp.solve_qp_factored`. ``device`` is where the
    fleet lives; every tensor handed to ``step`` must lie there.
    """
    device = resolve_device(device)
    params = LIPMParams(*(torch.as_tensor(p).to(device) for p in params))

    @torch.no_grad()
    def step(state: FleetState, disturbance, dcm_ref, zmp_ref, poly_A, poly_b):
        if disturbance.dim() != 3 or disturbance.shape[1] != 1:
            raise NotImplementedError(
                "the fleet tick takes disturbance of shape (B, 1, 2), got"
                f" {tuple(disturbance.shape)}: an ensemble of K > 1 push"
                " realizations needs the model axis of a device mesh; see"
                " ROADMAP.md 4.5, multi-device")
        if state.dcm.device.type != device.type:
            raise ValueError(
                f"fleet state lies on {state.dcm.device}, the step was built"
                f" for {device}")
        dist = disturbance[:, 0, :]
        # the carry's dtype is authoritative: cast every closed-over
        # parameter before mixing, or f64 params would promote an f32 fleet
        dtype = state.dcm.dtype
        p = LIPMParams(*(t.to(dtype) for t in params))
        omega_dt = lipm_omega(p) * torch.as_tensor(dt, dtype=dtype, device=device)
        a = torch.exp(omega_dt)

        # perturbed initial DCM: the lane solves under its own draw
        dcm0 = state.dcm + dist + state.offset_theta

        # fleet fast path: shared (P, A), batch rides on dcm0/warm starts
        plans = solve_dcm_mpc(
            p, dt, dcm0, state.com, dcm_ref, zmp_ref, poly_A, poly_b,
            weights, iterations=iterations,
            warm_start=state.warm_zmp, warm_start_dual=state.warm_y,
            s0=state.warm_s, shared=True, **qp_kwargs,
        )

        # fleet statistics; the ensemble mean/max over K == 1 are identities
        stats = reduce_fleet_stats(plans.qp)

        # worst-case constraint margin
        margins = torch.einsum("kfa,...ka->...kf", poly_A, plans.zmp) - poly_b
        worst = margins.max()

        # consensus plan: the average over the ensemble (K == 1: the plan)
        zmp_consensus = plans.zmp
        y_consensus = plans.qp.y
        s_consensus = plans.qp.rho_scale

        # advance the TRUE scenario state one knot under the consensus plan
        # and the fleet's actual push realization
        z0 = zmp_consensus[:, 0, :]
        true_dist = dist
        dcm_next = a * state.dcm + (1 - a) * z0 + true_dist
        com_next = com_discrete_step(p, state.com, state.dcm, z0, dt)

        # RLS: identify the UNMODELED additive DCM disturbance, the observed
        # transition residual minus the push the solve already anticipated
        # (otherwise the planner would double-compensate a modeled push).
        regressor = torch.eye(2, dtype=dtype, device=device).broadcast_to(
            (z0.shape[0], 2, 2))
        measurement = dcm_next - (a * state.dcm + (1 - a) * z0) - true_dist
        rls_p = RLSParams(
            lam=torch.as_tensor(rls_lambda, dtype=dtype, device=device),
            measurement_covariance=meas_noise * torch.eye(
                2, dtype=dtype, device=device),
        )
        est = rls_step(rls_p, RLSState(state.offset_theta, state.offset_cov),
                       regressor, measurement)

        new_state = FleetState(
            dcm=dcm_next,
            com=com_next,
            warm_zmp=zmp_consensus,
            warm_y=y_consensus,
            offset_theta=est.theta,
            offset_cov=est.covariance,
            warm_s=s_consensus,
        )

        # failure detection as data: per-lane status codes carried in the
        # batch, and NaN quarantine: a lane whose solve went non-finite
        # restarts from its last-good (pre-tick) scenario state with cleared
        # warm starts and a fresh estimator prior, instead of poisoning every
        # subsequent warm-started tick.
        status = classify_qp(plans.qp)
        reset = FleetState(
            dcm=state.dcm,
            com=state.com,
            warm_zmp=torch.zeros_like(state.warm_zmp),
            warm_y=torch.zeros_like(state.warm_y),
            offset_theta=torch.zeros_like(state.offset_theta),
            offset_cov=(10.0 * torch.eye(2, dtype=dtype, device=device)
                        ).broadcast_to(state.offset_cov.shape),
            warm_s=torch.ones_like(state.warm_s),
        )
        new_state = nan_quarantine(new_state, status, reset)
        bad = status == int(SolverStatus.NUMERICAL_ERROR)
        num_bad = bad.to(torch.float32).sum()
        return new_state, TickResult(stats, worst, z0, status, num_bad)

    return step
