"""Continuous spring-damper contact model over a rectangular patch.

Counterpart of ``blf_tpu/models/contact.py``. Ported: ``ContactParams``,
``ContactState``, ``contact_wrench``, ``autonomous_dynamics``,
``control_matrix``, ``wrench_rate``, ``regressor``, ``force_at_point``,
``torque_at_point`` and ``params_from_handler`` (which reads a handler of
:mod:`blf_tpu_torch.utils.params`); everything of it is ported.

Each product is a pure function of

- static parameters :class:`ContactParams`: patch ``length``/``width`` and
  ``spring_coeff``/``damper_coeff``, and
- the kinematic :class:`ContactState`: world frame pose, mixed-representation
  twist, and the *null-force* pose at which the patch exerts zero wrench.

Physical model: a continuum of springs (stiffness density ``k``) and dampers
(density ``b``) over the rectangle ``[-L/2, L/2] x [-W/2, W/2]``; the
products below are the closed-form surface integrals of the pointwise law
:func:`force_at_point`. All functions broadcast over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from blf_tpu_torch.ops.lie import rotation_rate_mixed, skew
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype

__all__ = [
    "ContactParams",
    "ContactState",
    "contact_wrench",
    "autonomous_dynamics",
    "control_matrix",
    "regressor",
    "wrench_rate",
    "force_at_point",
    "torque_at_point",
    "params_from_handler",
]


class ContactParams(NamedTuple):
    """Static patch parameters (scalars, or tensors that broadcast)."""

    length: torch.Tensor        # patch size along the frame x axis [m]
    width: torch.Tensor         # patch size along the frame y axis [m]
    spring_coeff: torch.Tensor  # spring density k [N/m^3]
    damper_coeff: torch.Tensor  # damper density b [N s/m^3]


def params_from_handler(handler, *, device=None,
                        dtype: Optional[torch.dtype] = None) -> ContactParams:
    """The four named parameters of the reference's ``initialize``
    (``length``, ``width``, ``spring_coeff``, ``damper_coeff``), read as
    floats; a missing key raises ``KeyError``, a non-number ``TypeError``.
    ``handler`` is duck-typed (``get_parameter(name, type)``)."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    return ContactParams(*(
        torch.tensor(handler.get_parameter(name, float), dtype=dtype, device=device)
        for name in ContactParams._fields))


class ContactState(NamedTuple):
    """Kinematic state of the contact frame and its zero-force reference.

    ``position``/``rotation`` are ``world_T_frame``; ``linear/angular_velocity``
    the mixed-representation frame twist; ``null_position``/``null_rotation``
    the pose at which the deformation field (and hence the wrench) vanishes.
    """

    position: torch.Tensor          # (..., 3)
    rotation: torch.Tensor          # (..., 3, 3)
    linear_velocity: torch.Tensor   # (..., 3)
    angular_velocity: torch.Tensor  # (..., 3)
    null_position: torch.Tensor     # (..., 3)
    null_rotation: torch.Tensor     # (..., 3, 3)


def _mv(m, v):
    return torch.einsum("...ij,...j->...i", m, v)


def contact_wrench(params: ContactParams, state: ContactState) -> torch.Tensor:
    """Closed-form contact wrench ``(..., 6)`` = [force; torque]:

    ``f = |R33| A (k (p0 - p) - b v)``,
    ``tau = |R33| A/12 [L^2 (b e1^2 w + k e1 r01) + W^2 (b e2^2 w + k e2 r02)]``

    with ``ei = skew(R e_i)`` and ``r0i`` the null-rotation columns.
    """
    L, W, k, b = params
    area = L * W
    R, R0 = state.rotation, state.null_rotation
    r33 = R[..., 2, 2].abs()[..., None]

    force = r33 * area * (
        k * (state.null_position - state.position) - b * state.linear_velocity)

    e1_hat = skew(R[..., :, 0])
    e2_hat = skew(R[..., :, 1])
    torque = r33 * (area / 12.0) * (
        L * L * (b * _mv(e1_hat @ e1_hat, state.angular_velocity)
                 + k * _mv(e1_hat, R0[..., :, 0]))
        + W * W * (b * _mv(e2_hat @ e2_hat, state.angular_velocity)
                   + k * _mv(e2_hat, R0[..., :, 1])))
    return torch.cat([force, torque], dim=-1)


def autonomous_dynamics(params: ContactParams, state: ContactState) -> torch.Tensor:
    """Autonomous part ``f`` of the wrench rate ``wdot = f + G a`` (``(..., 6)``).

    As in the reference, the *signed* ``R33`` is used here (the wrench uses
    ``|R33|``).
    """
    L, W, k, b = params
    area = L * W
    R, R0 = state.rotation, state.null_rotation
    v, omega = state.linear_velocity, state.angular_velocity

    R_dot = rotation_rate_mixed(R, omega)
    r33 = R[..., 2, 2][..., None]
    r33_dot = R_dot[..., 2, 2][..., None]

    lin = area * (
        r33_dot * (k * (state.null_position - state.position) - b * v)
        - r33 * k * v)

    e1_hat, e2_hat = skew(R[..., :, 0]), skew(R[..., :, 1])
    e1d_hat, e2d_hat = skew(R_dot[..., :, 0]), skew(R_dot[..., :, 1])

    ang = (area / 12.0) * (
        r33_dot * (
            L * L * (b * _mv(e1_hat @ e1_hat, omega) + k * _mv(e1_hat, R0[..., :, 0]))
            + W * W * (b * _mv(e2_hat @ e2_hat, omega) + k * _mv(e2_hat, R0[..., :, 1])))
        + r33 * (
            L * L * (k * _mv(e1d_hat, R0[..., :, 0])
                     + b * _mv(e1d_hat @ e1_hat + e1_hat @ e1d_hat, omega))
            + W * W * (k * _mv(e2d_hat, R0[..., :, 1])
                       + b * _mv(e2d_hat @ e2_hat + e2_hat @ e2d_hat, omega))))
    return torch.cat([lin, ang], dim=-1)


def control_matrix(params: ContactParams, state: ContactState) -> torch.Tensor:
    """Control matrix ``G`` of ``wdot = f + G a`` w.r.t. frame acceleration
    (``(..., 6, 6)``), block-diagonal: ``G11 = -A b R33 I3``,
    ``G22 = A/12 R33 b (L^2 e1^2 + W^2 e2^2)``."""
    L, W, _, b = params
    area = L * W
    R = state.rotation
    r33 = R[..., 2, 2][..., None, None]

    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    top_left = -area * b * r33 * eye3

    e1_hat, e2_hat = skew(R[..., :, 0]), skew(R[..., :, 1])
    bottom_right = (area / 12.0) * r33 * b * (
        L * L * (e1_hat @ e1_hat) + W * W * (e2_hat @ e2_hat))

    zeros = torch.zeros_like(top_left)
    top = torch.cat([top_left, zeros], dim=-1)
    bottom = torch.cat([zeros, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def wrench_rate(params: ContactParams, state: ContactState, acceleration) -> torch.Tensor:
    """``wdot = f(x) + G(x) a``."""
    acceleration = torch.as_tensor(acceleration, dtype=state.rotation.dtype,
                                   device=state.rotation.device)
    return autonomous_dynamics(params, state) + _mv(
        control_matrix(params, state), acceleration)


def regressor(params: ContactParams, state: ContactState) -> torch.Tensor:
    """Regressor ``A`` with ``w = A [k; b]`` (``(..., 6, 2)``), the input of
    the RLS estimator for online spring/damper identification."""
    L, W, _, _ = params
    area = L * W
    R, R0 = state.rotation, state.null_rotation
    r33 = R[..., 2, 2].abs()[..., None]

    e1_hat, e2_hat = skew(R[..., :, 0]), skew(R[..., :, 1])

    top_k = r33 * area * (state.null_position - state.position)
    top_b = -r33 * area * state.linear_velocity
    bot_k = (area / 12.0) * r33 * (
        L * L * _mv(e1_hat, R0[..., :, 0]) + W * W * _mv(e2_hat, R0[..., :, 1]))
    bot_b = (area / 12.0) * r33 * _mv(
        L * L * (e1_hat @ e1_hat) + W * W * (e2_hat @ e2_hat),
        state.angular_velocity)
    col_k = torch.cat([top_k, bot_k], dim=-1)
    col_b = torch.cat([top_b, bot_b], dim=-1)
    return torch.stack([col_k, col_b], dim=-1)


def _patch_point(state: ContactState, x, y):
    like = state.position
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    y = torch.as_tensor(y, dtype=like.dtype, device=like.device)
    x, y = torch.broadcast_tensors(x, y)
    return x, y, torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def force_at_point(params: ContactParams, state: ContactState, x, y) -> torch.Tensor:
    """Pointwise force density at patch coordinates ``(x, y)`` (``(..., 3)``):
    ``f(x, y) = k[(p0 - p) + (R0 - R) rho] - b[v + w^ R rho]``,
    ``rho = (x, y, 0)``; zero outside the patch."""
    L, W, k, b = params
    x, y, rho = _patch_point(state, x, y)
    R, R0 = state.rotation, state.null_rotation
    f = (k * ((state.null_position - state.position) + _mv(R0 - R, rho))
         - b * (state.linear_velocity + _mv(skew(state.angular_velocity) @ R, rho)))
    inside = (x.abs() <= L / 2) & (y.abs() <= W / 2)
    return torch.where(inside[..., None], f, torch.zeros_like(f))


def torque_at_point(params: ContactParams, state: ContactState, x, y) -> torch.Tensor:
    """Pointwise torque ``(R rho) x f(x, y)``."""
    _, _, rho = _patch_point(state, x, y)
    arm = _mv(state.rotation, rho)
    f = force_at_point(params, state, x, y)
    arm, f = torch.broadcast_tensors(arm, f)
    return torch.linalg.cross(arm, f, dim=-1)
