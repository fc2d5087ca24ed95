"""Rigid-foot spring-damper rollout: the compute core of BASELINE config 2.

Counterpart of ``blf_tpu/models/foot.py``; everything of it is ported. A
single rigid body (the foot) falls and settles on the continuous
spring-damper patch of :mod:`blf_tpu_torch.models.contact`, integrated with
forward Euler and batched over a fleet of scenarios.

Dynamics (mixed representation, foot frame at the CoM):

    pdot = v
    Rdot = w^ R + rho/2 ((R R')^-1 - I) R        (Baumgarte)
    vdot = f / m + g
    wdot = R I^-1 R' (tau - w x (R I R' w))      (diagonal body inertia)

with ``(f, tau) = contact_wrench(params, state)``, the closed-form patch
wrench.

Two execution paths with the same math (the reference's ``backend`` names in
brackets):

- ``backend="torch"`` (``"xla"``): a Python loop of :func:`foot_euler_step`,
  the 3x3 products with TF32 off (reduced-precision products cost 2e-3 in
  rotation over 50 stiff steps in the reference's measurement);
- ``backend="cuda"`` (``"pallas"``): the whole horizon in one hand-written
  kernel, :func:`blf_tpu_torch.ops.cuda.rollout.foot_rollout_fused`, one
  thread a lane with the state in registers. It takes one batch axis
  ``(B, ...)``, any ``B``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blf_tpu_torch.models.contact import ContactParams, ContactState, contact_wrench
from blf_tpu_torch.ops.cuda.rollout import GRAVITY_Z, foot_rollout_fused
from blf_tpu_torch.ops.lie import so3_baumgarte_rate
from blf_tpu_torch.ops.precision import f32_matmuls

__all__ = ["FootParams", "FootState", "foot_dynamics", "foot_euler_step",
           "foot_rollout"]


class FootParams(NamedTuple):
    """Rigid-foot body parameters (the contact patch's ride separately)."""

    mass: torch.Tensor           # scalar [kg]
    inertia: torch.Tensor        # (3,) diagonal body inertia at the CoM
    baumgarte_rho: torch.Tensor  # SO(3) stabilisation gain


class FootState(NamedTuple):
    """Batched foot state; every field broadcasts over leading axes."""

    position: torch.Tensor          # (..., 3)
    rotation: torch.Tensor          # (..., 3, 3)
    linear_velocity: torch.Tensor   # (..., 3)
    angular_velocity: torch.Tensor  # (..., 3)


def _mv(m, v):
    return torch.einsum("...ij,...j->...i", m, v)


def foot_dynamics(cparams: ContactParams, fparams: FootParams, state: FootState,
                  null_position: torch.Tensor, null_rotation: torch.Tensor) -> FootState:
    """State derivative of the contact-closed rigid foot (see the module doc)."""
    w = contact_wrench(cparams, ContactState(
        position=state.position, rotation=state.rotation,
        linear_velocity=state.linear_velocity,
        angular_velocity=state.angular_velocity,
        null_position=null_position, null_rotation=null_rotation))
    R = state.rotation
    g = torch.tensor([0.0, 0.0, GRAVITY_Z], dtype=R.dtype, device=R.device)
    v_dot = w[..., :3] / fparams.mass + g

    Rt = R.transpose(-1, -2)
    omega = state.angular_velocity
    I_diag = torch.as_tensor(fparams.inertia, dtype=R.dtype, device=R.device)
    Iw_omega = _mv(R, I_diag * _mv(Rt, omega))
    torque = w[..., 3:] - torch.linalg.cross(omega, Iw_omega, dim=-1)
    omega_dot = _mv(R, _mv(Rt, torque) / I_diag)
    return FootState(
        position=state.linear_velocity,
        rotation=so3_baumgarte_rate(R, omega, fparams.baumgarte_rho),
        linear_velocity=v_dot,
        angular_velocity=omega_dot,
    )


def foot_euler_step(cparams: ContactParams, fparams: FootParams, state: FootState,
                    null_position, null_rotation, dt) -> FootState:
    """One forward-Euler step, ``x += dt f(x)``."""
    d = foot_dynamics(cparams, fparams, state, null_position, null_rotation)
    return FootState(*(x + dt * dx for x, dx in zip(state, d)))


@f32_matmuls
def _rollout_torch(cparams, fparams, state, null_position, null_rotation, dt, steps):
    for _ in range(steps):
        state = foot_euler_step(cparams, fparams, state, null_position, null_rotation, dt)
    return state


def foot_rollout(cparams: ContactParams, fparams: FootParams, state: FootState,
                 null_position: torch.Tensor, null_rotation: torch.Tensor,
                 dt: float, steps: int, *, backend: str = "torch") -> FootState:
    """Integrate ``steps`` Euler steps; returns the final state.

    ``backend="cuda"`` runs the whole horizon in one kernel launch (on CPU
    tensors, its plain version): every state field ``(B, ...)`` with one
    batch axis, the null pose ``(B, ...)`` or one pose for all lanes, and
    ``spring_coeff``/``damper_coeff`` scalar, ``(B,)`` or ``(B, 1)``.
    ``backend="torch"`` takes anything that broadcasts.
    """
    if backend == "cuda":
        return foot_rollout_fused(cparams, fparams, state, null_position, null_rotation,
                                  dt=dt, steps=steps)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    return _rollout_torch(cparams, fparams, state, null_position, null_rotation, dt, steps)
