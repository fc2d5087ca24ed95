"""The MPC fleet tick: the framework's "training step" equivalent.

Counterpart of ``blf_tpu/parallel/sweep.py``. One control tick for a fleet
of push-recovery scenarios:

    warm-started batched DCM-MPC solve -> fleet statistics -> state advance
    under the consensus plan + disturbance -> per-lane RLS update of a
    ZMP-offset disturbance estimate -> per-lane status + NaN quarantine.

The reference writes the tick as a ``shard_map`` program over a ``(data,
model)`` mesh: ``data`` splits the fleet, and ``model`` carries a
disturbance ensemble, ``K`` push realizations a scenario, combined by
``pmean``/``pmax`` over the axis. The port runs the same program as
explicit SPMD on a :func:`blf_tpu_torch.parallel.mesh.make_mesh` mesh (one
rank a device), or on one device with ``mesh=None``. A rank's
``disturbance`` is ``(B_local, K_local, 2)``: its ``K_local`` members are
folded into the lane axis of one solve (``B_local * K_local`` lanes, one
kernel launch a stage), and the ensemble's means and maxima run over the
local members, then over the ``model`` group: ``K = K_local x`` the model
axis size. With ``mesh=None`` the whole ensemble is local.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from blf_tpu_torch.estimators.rls import RLSParams, RLSState, rls_step
from blf_tpu_torch.models.lipm import LIPMParams, com_discrete_step, lipm_omega
from blf_tpu_torch.mpc.dcm import DCMWeights, solve_dcm_mpc
from blf_tpu_torch.parallel.collectives import (FleetStats, pmax_tree, psum_tree,
                                                reduce_fleet_stats)
from blf_tpu_torch.parallel.mesh import axis_size
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
    mesh=None,
    **qp_kwargs,
):
    """Build the tick function.

    Returns ``step(state, disturbance, dcm_ref, zmp_ref, poly_A, poly_b)
    -> (FleetState, TickResult)`` where ``disturbance`` is ``(B, K_local, 2)``:
    ``K_local`` push realizations of each of the ``B`` scenarios. Extra
    ``qp_kwargs`` (e.g. ``backend="cuda"``, ``"cuda_split"`` or
    ``"cuda_delta"`` (``bench.py``'s mode, the reference's ``"pallas"``),
    ``check_every``, ``polish_iters``) pass through to
    :func:`blf_tpu_torch.mpc.qp.solve_qp_factored`. ``device`` is where the
    fleet lives; every tensor handed to ``step`` must lie there.

    ``mesh``: a ``(data, model)`` mesh of
    :func:`blf_tpu_torch.parallel.mesh.make_mesh`, on the same device type.
    Every rank of the mesh calls ``step`` with its own shard of the fleet
    (:func:`blf_tpu_torch.parallel.mesh.shard_batch` over ``data``) and its
    own ``K_local`` members of the ensemble; the statistics, the worst
    margin and the quarantine count come back the same on every rank, the
    state and the per-lane results as the rank's shard, identical across a
    model group. ``mesh=None``: one device, the whole ensemble local.
    """
    device = resolve_device(device)
    params = LIPMParams(*(torch.as_tensor(p).to(device) for p in params))
    if mesh is None:
        data_group = model_group = None
        model_size = 1
    else:
        if mesh.device_type != device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the step was built for {device}")
        if mesh.get_coordinate() is None:
            raise ValueError("this rank is not in the mesh: only its ranks run the tick")
        data_axis, model_axis = mesh.mesh_dim_names
        data_group, model_group = mesh.get_group(data_axis), mesh.get_group(model_axis)
        model_size = axis_size(mesh, model_axis)
    over_model = lambda reduce, tree: tree if model_group is None else reduce(tree, model_group)
    over_data = lambda reduce, tree: tree if data_group is None else reduce(tree, data_group)

    @torch.no_grad()
    def step(state: FleetState, disturbance, dcm_ref, zmp_ref, poly_A, poly_b):
        B = state.dcm.shape[0]
        if disturbance.dim() != 3 or disturbance.shape[0] != B or disturbance.shape[2] != 2:
            raise ValueError(
                f"the fleet tick takes disturbance of shape (B, K_local, 2) with B = {B},"
                f" got {tuple(disturbance.shape)}")
        if state.dcm.device.type != device.type:
            raise ValueError(
                f"fleet state lies on {state.dcm.device}, the step was built"
                f" for {device}")
        K_local = disturbance.shape[1]
        K = K_local * model_size                    # the whole ensemble
        # the K_local members of a scenario ride the lane axis of one solve,
        # member index minor: lane b * K_local + k
        lanes = lambda t: t if K_local == 1 else t.repeat_interleave(K_local, 0)
        members = lambda t: t.reshape((B, K_local) + t.shape[1:])

        def ensemble_mean(tree, axis):
            """The mean over all K members, held on ``axis`` of each tensor: the
            local sum, summed over the model group, divided once (the same on
            every rank of the group)."""
            return tuple(t / K for t in over_model(psum_tree, tuple(t.sum(axis) for t in tree)))

        def ensemble_max(tree, axis):
            return over_model(pmax_tree, tuple(t.amax(axis) for t in tree))

        # the carry's dtype is authoritative: cast every closed-over
        # parameter before mixing, or f64 params would promote an f32 fleet
        dtype = state.dcm.dtype
        p = LIPMParams(*(t.to(dtype) for t in params))
        omega_dt = lipm_omega(p) * torch.as_tensor(dt, dtype=dtype, device=device)
        a = torch.exp(omega_dt)

        # ensemble-perturbed initial DCM: each member solves its own draw
        dcm0 = (state.dcm[:, None] + disturbance + state.offset_theta[:, None]).reshape(
            B * K_local, 2)

        # fleet fast path: shared (P, A), batch rides on dcm0/warm starts
        plans = solve_dcm_mpc(
            p, dt, dcm0, lanes(state.com), dcm_ref, zmp_ref, poly_A, poly_b,
            weights, iterations=iterations,
            warm_start=lanes(state.warm_zmp), warm_start_dual=lanes(state.warm_y),
            s0=lanes(state.warm_s), shared=True, **qp_kwargs,
        )

        # collective QP reduce over the whole fleet: each member's statistics
        # over the data axis, then the ensemble's (mean counts, worst residuals)
        qp = plans.qp
        # each member's lanes contiguous, as a fleet of K = 1 holds them: the
        # same sums in the same order (identical draws give the K = 1 stats)
        member = lambda t, k: members(t)[:, k].contiguous()
        per_member = [reduce_fleet_stats(qp._replace(
            converged=member(qp.converged, k),
            primal_residual=member(qp.primal_residual, k),
            dual_residual=member(qp.dual_residual, k),
            objective=member(qp.objective, k)), data_group) for k in range(K_local)]
        member_stats = FleetStats(*(torch.stack(f) for f in zip(*per_member)))   # (K_local,)
        n, conv, obj = ensemble_mean((member_stats.num_scenarios, member_stats.num_converged,
                                      member_stats.mean_objective), 0)
        rp, rd = ensemble_max((member_stats.max_primal_residual,
                               member_stats.max_dual_residual), 0)
        stats = FleetStats(n, conv, rp, rd, obj)

        # worst-case constraint margin across the ensemble and the fleet
        margins = torch.einsum("kfa,...ka->...kf", poly_A, plans.zmp) - poly_b
        worst = over_data(pmax_tree, over_model(pmax_tree, margins.max()))

        # consensus plan: certainty-equivalent average over the ensemble, and
        # the fleet's actual push realization
        zmp_consensus, y_consensus, s_consensus, true_dist = ensemble_mean(
            (members(plans.zmp), members(plans.qp.y), members(plans.qp.rho_scale),
             disturbance), 1)

        # advance the TRUE scenario state one knot under the consensus plan
        # and the fleet's actual push realization
        z0 = zmp_consensus[:, 0, :]
        dcm_next = a * state.dcm + (1 - a) * z0 + true_dist
        com_next = com_discrete_step(p, state.com, state.dcm, z0, dt)

        # RLS: identify the UNMODELED additive DCM disturbance, the observed
        # transition residual minus the push the ensemble already anticipated
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
        # subsequent warm-started tick. The worst status across the ensemble
        # (the codes are ordered by severity: any member failed, the scenario
        # failed), so the status is the same on every rank of a model group,
        # like the consensus state it guards.
        status, = ensemble_max((members(classify_qp(plans.qp)),), 1)
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
        num_bad = over_data(psum_tree, bad.to(torch.float32).sum())
        return new_state, TickResult(stats, worst, z0, status, num_bad)

    return step
