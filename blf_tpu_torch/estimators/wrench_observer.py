"""Momentum-based external contact-wrench observer (batched filter).

Counterpart of ``blf_tpu/estimators/wrench_observer.py``; everything of it is
ported. With the floating-base dynamics as the engine integrates them,

    M(q) nudot + h(q, nu) = B tau + tau_ext ,      p = M(q) nu

the generalized momentum evolves as ``pdot = Mdot nu - h + B tau + tau_ext``.
``Mdot nu`` is computed exactly by ``torch.func.jvp`` of ``q -> M(q) nu``
along the state flow, as ``rigid_body.bias_forces`` computes ``Jdot nu``. The
observer integrates the modeled part and feeds back the gap:

    r = K (p - int (Mdot nu - h + B tau + r) dt - p(0))   =>   rdot = K (tau_ext - r)

so the residual ``r`` is a first-order filter of the external generalized
force ``tau_ext = sum J_c' w_c`` with bandwidth ``K`` [rad/s]. Contact
wrenches are then recovered per frame by least squares over the stacked
contact Jacobians.

Where the reference's functions are single-sample and ``vmap``-ped, these
take the batch as leading dimensions of the state (and of the torques and the
residual); ``lax.scan`` over samples becomes a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from blf_tpu_torch.models.kinematics import (KinematicTree, forward_kinematics,
                                             frame_jacobian)
from blf_tpu_torch.models.rigid_body import (GRAVITY, FloatingBaseState,
                                             _flow_tangents, bias_forces,
                                             mass_matrix)
from blf_tpu_torch.ops.precision import f32_matmuls

__all__ = [
    "MomentumObserverParams",
    "MomentumObserverState",
    "init_momentum_observer",
    "momentum_observer_step",
    "wrench_normal_equations",
    "momentum_observer_scan",
    "wrenches_from_residual",
]


class MomentumObserverParams(NamedTuple):
    """``gain``: residual bandwidth K (scalar or (6+n,)) in rad/s; ``dt``:
    the sample period."""

    gain: torch.Tensor
    dt: torch.Tensor


class MomentumObserverState(NamedTuple):
    """Filter carry: the integral term, seeded with p(0) so r(0) = 0."""

    integral: torch.Tensor   # (..., 6+n) int(Mdot nu - h + B tau + r)dt + p(0)
    residual: torch.Tensor   # (..., 6+n) latest r


def _apply(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _momentum_and_rate(tree: KinematicTree, state: FloatingBaseState, gravity):
    """(p, Mdot nu - h): generalized momentum and its input-free rate."""
    nu = torch.cat([state.base_twist, state.joint_velocities], dim=-1)

    def p_map(bp, bR, qq):
        return _apply(mass_matrix(tree, bp, bR, qq), nu)

    # Mdot nu exactly: differentiate q -> M(q) nu along the state flow
    # (pdot = v, Rdot = w^ R, qdot); nu is held constant inside p_map
    p, mdot_nu = torch.func.jvp(
        p_map, (state.base_position, state.base_rotation, state.joint_positions),
        _flow_tangents(state.base_rotation, state.base_twist, state.joint_velocities))
    h = bias_forces(tree, state.base_position, state.base_rotation,
                    state.joint_positions, state.base_twist,
                    state.joint_velocities, gravity)
    return p, mdot_nu - h


def init_momentum_observer(
    tree: KinematicTree,
    state: FloatingBaseState,
    gain,
    dt,
    gravity=GRAVITY,
) -> Tuple[MomentumObserverParams, MomentumObserverState]:
    """Params + state with the integral seeded at p(0) (residual starts 0)."""
    nu = torch.cat([state.base_twist, state.joint_velocities], dim=-1)
    p0 = _apply(mass_matrix(tree, state.base_position, state.base_rotation,
                            state.joint_positions), nu)
    as_t = lambda a: torch.as_tensor(a, dtype=p0.dtype, device=p0.device)
    params = MomentumObserverParams(gain=as_t(gain), dt=as_t(dt))
    return params, MomentumObserverState(integral=p0, residual=torch.zeros_like(p0))


@f32_matmuls
def momentum_observer_step(
    tree: KinematicTree,
    params: MomentumObserverParams,
    obs: MomentumObserverState,
    state: FloatingBaseState,
    joint_torques: torch.Tensor,
    gravity=GRAVITY,
) -> Tuple[MomentumObserverState, torch.Tensor]:
    """One observer tick at the sampled state; returns (state, r).

    ``state`` is the sample at the END of the tick's interval and
    ``joint_torques`` the actuation over it. Backward Euler, solved in closed
    form: ``r+ = K (p - I - dt (modeled rate)) / (1 + K dt)``.
    """
    p, rate = _momentum_and_rate(tree, state, gravity)
    tau_gen = torch.nn.functional.pad(joint_torques, (6, 0))
    predicted = obs.integral + params.dt * (rate + tau_gen)
    r = params.gain * (p - predicted) / (1.0 + params.gain * params.dt)
    integral = predicted + params.dt * r
    return MomentumObserverState(integral=integral, residual=r), r


def momentum_observer_scan(
    tree: KinematicTree,
    params: MomentumObserverParams,
    obs: MomentumObserverState,
    states: FloatingBaseState,
    joint_torques: torch.Tensor,
    gravity=GRAVITY,
) -> Tuple[MomentumObserverState, torch.Tensor]:
    """Run the observer along a sampled trajectory (leading time axis on
    ``states``/``joint_torques``); returns the final state and the residual
    history (T, ..., 6+n)."""
    residuals = []
    for k in range(joint_torques.shape[0]):
        sample = FloatingBaseState(*(leaf[k] for leaf in states))
        obs, r = momentum_observer_step(tree, params, obs, sample,
                                        joint_torques[k], gravity)
        residuals.append(r)
    return obs, torch.stack(residuals, dim=0)


def wrenches_from_residual(
    tree: KinematicTree,
    state: FloatingBaseState,
    frames: Sequence[str],
    residual: torch.Tensor,
    *,
    reg: float = 1e-9,
) -> torch.Tensor:
    """Per-frame contact wrenches (..., len(frames), 6) from the residual:
    the least-squares solve of ``J' f = r`` over the stacked contact
    Jacobians, ``(J J' + reg I) f = J r``, by the library's dense solve (the
    reference's ``jnp.linalg.solve``)."""
    G, Jr = wrench_normal_equations(tree, state, frames, residual, reg=reg)
    f = torch.linalg.solve(G, Jr[..., None])[..., 0]
    return f.reshape(tuple(f.shape[:-1]) + (len(frames), 6))


@f32_matmuls
def wrench_normal_equations(
    tree: KinematicTree,
    state: FloatingBaseState,
    frames: Sequence[str],
    residual: torch.Tensor,
    *,
    reg: float = 1e-9,
):
    """The ``(G, J r)`` pair of :func:`wrenches_from_residual` without the
    solve, so that a fleet routes the small SPD solve through
    :func:`blf_tpu_torch.ops.cuda.linalg.spd_solve_lane`: ``G`` (..., 6k, 6k),
    ``J r`` (..., 6k)."""
    poses = forward_kinematics(tree, state.base_position, state.base_rotation,
                               state.joint_positions)
    J = torch.cat([frame_jacobian(tree, poses, f) for f in frames], dim=-2)
    k6 = J.shape[-2]
    G = J @ J.transpose(-1, -2) + reg * torch.eye(k6, dtype=J.dtype, device=J.device)
    return G, _apply(J, residual)
