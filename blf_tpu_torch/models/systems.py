"""Continuous-time dynamical systems as pure functions.

Counterpart of ``blf_tpu/models/systems.py``; everything of it is ported.
Each system is a parameter NamedTuple plus a pure ``f(state, input, t) ->
dstate`` that the integrators of :mod:`blf_tpu_torch.ops.integrators` take.
All functions broadcast over leading batch axes.

- :func:`lti_dynamics`: ``dx = A x + B u``.
- :func:`floating_base_kinematics`: mixed-representation base twist,
  Baumgarte-stabilised SO(3) rotation rate.

The full articulated floating-base system lives in
:mod:`blf_tpu_torch.models.rigid_body`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from blf_tpu_torch.ops.lie import so3_baumgarte_rate

__all__ = [
    "LTIParams",
    "lti_dynamics",
    "FloatingBaseKinState",
    "FloatingBaseKinInput",
    "floating_base_kinematics",
]


class LTIParams(NamedTuple):
    """``dx = A x + B u`` matrices."""

    A: torch.Tensor  # (..., n, n)
    B: torch.Tensor  # (..., n, m)

    def validate(self) -> "LTIParams":
        """The reference's shape checks: ``A`` square, ``A`` and ``B`` with the
        same number of rows (``ValueError`` otherwise)."""
        A, B = torch.as_tensor(self.A), torch.as_tensor(self.B)
        if A.shape[-1] != A.shape[-2]:
            raise ValueError("A must be square")
        if A.shape[-2] != B.shape[-2]:
            raise ValueError("A and B must have the same number of rows")
        return LTIParams(A, B)


def lti_dynamics(params: LTIParams, x: torch.Tensor, u: torch.Tensor, t=0.0):
    """``dx = A x + B u``."""
    del t
    return (torch.einsum("...ij,...j->...i", params.A, x)
            + torch.einsum("...ij,...j->...i", params.B, u))


class FloatingBaseKinState(NamedTuple):
    """State of the floating-base kinematics (p, R, s)."""

    position: torch.Tensor         # (..., 3) world base position
    rotation: torch.Tensor         # (..., 3, 3) world_R_base
    joint_positions: torch.Tensor  # (..., n)


class FloatingBaseKinInput(NamedTuple):
    """Input (base twist in mixed representation, joint velocities)."""

    base_twist: torch.Tensor        # (..., 6) [v; w]
    joint_velocities: torch.Tensor  # (..., n)


def floating_base_kinematics(state: FloatingBaseKinState, inp: FloatingBaseKinInput,
                             t=0.0, *, rho: float = 0.0) -> FloatingBaseKinState:
    """``(pdot, Rdot, sdot)`` with ``pdot = v``,
    ``Rdot = w^ R + rho/2 ((R R')^-1 - I) R`` and ``sdot`` the input joint
    velocities; ``rho`` is the reference's ``"rho"`` parameter."""
    del t
    v = inp.base_twist[..., :3]
    omega = inp.base_twist[..., 3:]
    return FloatingBaseKinState(
        position=v,
        rotation=so3_baumgarte_rate(state.rotation, omega, rho),
        joint_positions=inp.joint_velocities,
    )
