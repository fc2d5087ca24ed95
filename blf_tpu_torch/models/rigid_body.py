"""Floating-base rigid-body dynamics: mass matrix, bias forces, forward dynamics.

Counterpart of ``blf_tpu/models/rigid_body.py``; everything of it is ported.

Formulation (all in the mixed representation):

- Per-link spatial inertia at the link origin, world axes:
  ``I_i = [[m 1, -m c^], [m c^, R I_c R' - m c^ c^]]`` with ``c = R c_local``.
- Mass matrix by Jacobian composition: ``M(q) = sum_i J_i' I_i J_i``.
- Bias forces by the Newton-Euler balance in the hybrid frame:
  ``h = sum_i J_i' (I_i (Jdot_i nu) + beta_i - f_i^grav)`` with the velocity
  bias ``beta_i = [m w x (w x c); w^ (R I_c R') w + m c x (w x (w x c))]``.
  ``Jdot_i nu`` is obtained **exactly** with ``torch.func.jvp`` of the
  link-velocity map along the state flow (pdot = v, Rdot = w^ R, qdot).
- Forward dynamics: ``nudot = (M [+ M_reg])^-1 (-h + sum J_c' w_c + B tau)``
  by Cholesky, with SO(3) Baumgarte rotation propagation.

Where the reference's functions are single-sample and ``vmap``-ped, these
take the batch as leading dimensions written out (``q`` (..., n), ``nu``
(..., 6+n), ...) and work unbatched too; the link axis follows the batch.
The ``jvp`` runs on the batch-explicit functions directly.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional

import torch

from blf_tpu_torch.models.contact import ContactState, contact_wrench
from blf_tpu_torch.models.kinematics import (
    KinematicTree,
    LinkPoses,
    _attached_point_jacobians,
    forward_kinematics,
    frame_jacobian,
    frame_pose,
    link_jacobians,
    tree_constants,
)
from blf_tpu_torch.ops.lie import skew, so3_baumgarte_rate
from blf_tpu_torch.ops.linalg import cholesky_nan
from blf_tpu_torch.ops.precision import f32_matmuls

__all__ = [
    "GRAVITY",
    "spatial_inertias",
    "mass_matrix",
    "link_velocities",
    "bias_forces",
    "generalized_gravity",
    "total_momentum",
    "kinetic_energy",
    "FloatingBaseState",
    "FloatingBaseInput",
    "floating_base_dynamics",
    "frame_velocity",
    "frame_kinematics",
    "frame_bias_acceleration",
    "com_position",
    "com_jacobian",
    "com_velocity",
    "com_bias_acceleration",
    "make_contact_dynamics",
]

#: plain numbers: no tensor is made at import
GRAVITY = (0.0, 0.0, -9.81)


@functools.lru_cache(maxsize=None)
def _gravity_constant(gravity: tuple, device, dtype) -> torch.Tensor:
    return torch.tensor(gravity, dtype=dtype, device=device)


def _gravity(gravity, like: torch.Tensor) -> torch.Tensor:
    """The gravity vector as a tensor beside ``like``. A tuple of numbers is
    uploaded once per (value, device, dtype), not on every evaluation of the
    dynamics: in eager PyTorch that would be a host-to-device copy each."""
    if isinstance(gravity, torch.Tensor):
        return gravity.to(device=like.device, dtype=like.dtype)
    return _gravity_constant(tuple(float(g) for g in gravity), like.device, like.dtype)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _world_com_offsets(c, R):
    """(..., L, 3) link CoM offsets in world axes, ``R c_local``."""
    return (R @ c.com[..., None])[..., 0]


def spatial_inertias(tree: KinematicTree, poses: LinkPoses) -> torch.Tensor:
    """(..., L, 6, 6) mixed-frame spatial inertia of every link at its origin."""
    R = poses.rotation
    k = tree_constants(tree, R.device, R.dtype)
    m = k.mass[:, None, None]
    c_hat = skew(_world_com_offsets(k, R))
    I_c = R @ k.inertia @ R.transpose(-1, -2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    top = torch.cat([(m * eye).expand(c_hat.shape), -m * c_hat], dim=-1)
    bottom = torch.cat([m * c_hat, I_c - m * (c_hat @ c_hat)], dim=-1)
    return torch.cat([top, bottom], dim=-2)


@f32_matmuls
def mass_matrix(tree: KinematicTree, base_position, base_rotation, q,
                poses: Optional[LinkPoses] = None) -> torch.Tensor:
    """Free-floating mass matrix (..., 6+n, 6+n) w.r.t. mixed nu."""
    if poses is None:
        poses = forward_kinematics(tree, base_position, base_rotation, q)
    J = link_jacobians(tree, poses)          # (..., L, 6, nv)
    I = spatial_inertias(tree, poses)        # (..., L, 6, 6)
    return torch.einsum("...lki,...lkj->...ij", J, I @ J)


def link_velocities(tree: KinematicTree, base_position, base_rotation, q, nu,
                    poses: Optional[LinkPoses] = None) -> torch.Tensor:
    """(..., L, 6) mixed velocity of every link origin: ``v_i = J_i nu``."""
    if poses is None:
        poses = forward_kinematics(tree, base_position, base_rotation, q)
    J = link_jacobians(tree, poses)
    return torch.einsum("...lij,...j->...li", J, nu)


def _velocity_bias(tree: KinematicTree, poses: LinkPoses, vels: torch.Tensor):
    """Hybrid-frame Newton-Euler velocity bias beta_i (see module docstring)."""
    R = poses.rotation
    k = tree_constants(tree, R.device, R.dtype)
    m = k.mass[:, None]
    c = _world_com_offsets(k, R)
    I_c = R @ k.inertia @ R.transpose(-1, -2)
    omega = vels[..., 3:]
    wxwxc = _cross(omega, _cross(omega, c))
    beta_lin = m * wxwxc
    beta_ang = _cross(omega, torch.einsum("...lij,...lj->...li", I_c, omega)) \
        + m * _cross(c, wxwxc)
    return torch.cat([beta_lin, beta_ang], dim=-1)


def _gravity_wrenches(tree: KinematicTree, poses: LinkPoses, gravity) -> torch.Tensor:
    """(..., L, 6) mixed gravity wrench on each link at its origin."""
    R = poses.rotation
    k = tree_constants(tree, R.device, R.dtype)
    c = _world_com_offsets(k, R)
    f = (k.mass[:, None] * gravity).expand(c.shape)
    return torch.cat([f, _cross(c, f)], dim=-1)


def _flow_tangents(base_rotation, base_twist, qdot):
    """Tangents of (base position, base rotation, q) along the state flow."""
    return (base_twist[..., :3], skew(base_twist[..., 3:]) @ base_rotation, qdot)


@f32_matmuls
def bias_forces(tree: KinematicTree, base_position, base_rotation, q,
                base_twist, qdot, gravity=GRAVITY,
                poses: Optional[LinkPoses] = None) -> torch.Tensor:
    """Generalized bias forces ``h(q, nu) = C nu + G`` (..., 6+n)."""
    nu = torch.cat([base_twist, qdot], dim=-1)
    if poses is None:
        poses = forward_kinematics(tree, base_position, base_rotation, q)

    # Jdot nu exactly, via jvp along the state flow (pdot = v, Rdot = w^ R, qdot)
    def vel_map(bp, bR, qq):
        return link_velocities(tree, bp, bR, qq, nu)

    _, jdot_nu = torch.func.jvp(
        vel_map, (base_position, base_rotation, q),
        _flow_tangents(base_rotation, base_twist, qdot))

    J = link_jacobians(tree, poses)
    I = spatial_inertias(tree, poses)
    vels = torch.einsum("...lij,...j->...li", J, nu)
    beta = _velocity_bias(tree, poses, vels)
    f_grav = _gravity_wrenches(tree, poses, _gravity(gravity, q))
    net = torch.einsum("...lij,...lj->...li", I, jdot_nu) + beta - f_grav
    return torch.einsum("...lij,...li->...j", J, net)


def generalized_gravity(tree: KinematicTree, base_position, base_rotation, q,
                        gravity=GRAVITY) -> torch.Tensor:
    """Gravity part ``G(q)`` alone (h with nu = 0)."""
    poses = forward_kinematics(tree, base_position, base_rotation, q)
    J = link_jacobians(tree, poses)
    f_grav = _gravity_wrenches(tree, poses, _gravity(gravity, q))
    return -torch.einsum("...lij,...li->...j", J, f_grav)


def total_momentum(tree: KinematicTree, base_position, base_rotation, q, nu
                   ) -> torch.Tensor:
    """Total spatial momentum (..., 6) about the world origin: conserved for a
    free-floating system without external forces."""
    poses = forward_kinematics(tree, base_position, base_rotation, q)
    I = spatial_inertias(tree, poses)
    v = link_velocities(tree, base_position, base_rotation, q, nu, poses)
    h_links = torch.einsum("...lij,...lj->...li", I, v)   # momenta at link origins
    lin = h_links[..., :3].sum(dim=-2)
    ang = (h_links[..., 3:] + _cross(poses.position, h_links[..., :3])).sum(dim=-2)
    return torch.cat([lin, ang], dim=-1)


def kinetic_energy(tree: KinematicTree, base_position, base_rotation, q, nu):
    M = mass_matrix(tree, base_position, base_rotation, q)
    return 0.5 * torch.einsum("...i,...ij,...j->...", nu, M, nu)


# ---------------------------------------------------------------------------
# Frame kinematics (contact attachment points)
# ---------------------------------------------------------------------------

def _apply(J, nu):
    return torch.einsum("...ij,...j->...i", J, nu)


def frame_velocity(tree: KinematicTree, poses: LinkPoses, frame: str, nu):
    """Mixed 6D velocity of a named frame."""
    return _apply(frame_jacobian(tree, poses, frame), nu)


def frame_kinematics(tree: KinematicTree, poses: LinkPoses, frame: str, nu):
    """(rotation, position, velocity6) of a named frame in one go."""
    R, p = frame_pose(tree, poses, frame)
    return R, p, _apply(frame_jacobian(tree, poses, frame), nu)


@f32_matmuls
def frame_bias_acceleration(tree: KinematicTree, base_position, base_rotation,
                            q, base_twist, qdot, frame: str) -> torch.Tensor:
    """``Jdot_f nu`` (..., 6): the frame acceleration at zero generalized
    acceleration, exact via ``torch.func.jvp`` along the state flow. Needed by
    acceleration-level contact constraints in the whole-body QP."""
    nu = torch.cat([base_twist, qdot], dim=-1)

    def vel(bp, bR, qq):
        poses = forward_kinematics(tree, bp, bR, qq)
        return _apply(frame_jacobian(tree, poses, frame), nu)

    _, jdot_nu = torch.func.jvp(
        vel, (base_position, base_rotation, q),
        _flow_tangents(base_rotation, base_twist, qdot))
    return jdot_nu


# -- Centre of mass ---------------------------------------------------------

def _link_coms(tree: KinematicTree, poses: LinkPoses):
    k = tree_constants(tree, poses.position.device, poses.position.dtype)
    return k, poses.position + _world_com_offsets(k, poses.rotation)


def com_position(tree: KinematicTree, poses: LinkPoses) -> torch.Tensor:
    """World CoM (..., 3)."""
    k, com_links = _link_coms(tree, poses)
    return torch.einsum("l,...li->...i", k.mass, com_links) / k.mass.sum()


def com_jacobian(tree: KinematicTree, poses: LinkPoses) -> torch.Tensor:
    """Linear CoM Jacobian (..., 3, 6+n): ``xdot_com = J_com nu``; the
    mass-weighted mean of the Jacobians of the links' CoM points, all formed
    at once."""
    k, com_links = _link_coms(tree, poses)
    J = _attached_point_jacobians(tree, poses, com_links)[..., :3, :]
    return torch.einsum("l,...lij->...ij", k.mass, J) / k.mass.sum()


def com_velocity(tree: KinematicTree, poses: LinkPoses, nu) -> torch.Tensor:
    return _apply(com_jacobian(tree, poses), nu)


def com_bias_acceleration(tree: KinematicTree, base_position, base_rotation,
                          q, base_twist, qdot) -> torch.Tensor:
    """``Jdot_com nu`` (..., 3), exact via jvp (see :func:`frame_bias_acceleration`)."""
    nu = torch.cat([base_twist, qdot], dim=-1)

    def vel(bp, bR, qq):
        poses = forward_kinematics(tree, bp, bR, qq)
        return _apply(com_jacobian(tree, poses), nu)

    _, jdot_nu = torch.func.jvp(
        vel, (base_position, base_rotation, q),
        _flow_tangents(base_rotation, base_twist, qdot))
    return jdot_nu


# ---------------------------------------------------------------------------
# The floating-base dynamical system as a pure function
# ---------------------------------------------------------------------------

class FloatingBaseState(NamedTuple):
    """(base twist, joint velocities, base position, base rotation, joints)."""

    base_twist: torch.Tensor        # (..., 6) mixed
    joint_velocities: torch.Tensor  # (..., n)
    base_position: torch.Tensor     # (..., 3)
    base_rotation: torch.Tensor     # (..., 3, 3)
    joint_positions: torch.Tensor   # (..., n)


class FloatingBaseInput(NamedTuple):
    """Input: joint torques (..., n) and per-contact-frame wrenches, a mapping
    frame name -> (..., 6) mixed wrench."""

    joint_torques: torch.Tensor
    contact_wrenches: Dict[str, torch.Tensor]


@f32_matmuls
def floating_base_dynamics(
    tree: KinematicTree,
    state: FloatingBaseState,
    inp: FloatingBaseInput,
    t=0.0,
    *,
    rho: float = 0.0,
    gravity=GRAVITY,
    mass_matrix_regularization: Optional[torch.Tensor] = None,
    minv: Optional[torch.Tensor] = None,
    minv_refine: int = 2,
) -> FloatingBaseState:
    """Full articulated forward dynamics as a pure function:

    1. base kinematics with Baumgarte SO(3) stabilisation;
    2. ``M``, ``h`` from the articulated model;
    3. ``known = -h + sum J_c' w_c + B tau``;
    4. ``nudot = (M [+ M_reg])^-1 known`` by Cholesky.

    Returns the state derivative as a :class:`FloatingBaseState`
    (integrator-ready).

    ``minv``: optional LAGGED mass-matrix inverse (..., nv, nv), e.g. computed
    once per control tick. When given, the Cholesky solve is replaced by the
    preconditioned iterate ``nudot <- nudot + minv (known - M nudot)``
    (``minv_refine`` passes against the EXACT current ``M``).
    """
    poses = forward_kinematics(
        tree, state.base_position, state.base_rotation, state.joint_positions)
    M = mass_matrix(tree, state.base_position, state.base_rotation,
                    state.joint_positions, poses)
    h = bias_forces(tree, state.base_position, state.base_rotation,
                    state.joint_positions, state.base_twist,
                    state.joint_velocities, gravity, poses)

    known = -h
    for frame_name, wrench in inp.contact_wrenches.items():
        Jc = frame_jacobian(tree, poses, frame_name)
        known = known + torch.einsum("...ij,...i->...j", Jc, wrench)
    known = known + torch.nn.functional.pad(inp.joint_torques, (6, 0))

    if mass_matrix_regularization is not None:
        M = M + mass_matrix_regularization
    if minv is not None:
        nu_dot = _apply(minv, known)
        for _ in range(max(0, minv_refine)):
            nu_dot = nu_dot + _apply(minv, known - _apply(M, nu_dot))
    else:
        L = cholesky_nan(M)
        nu_dot = torch.cholesky_solve(known[..., None], L)[..., 0]

    return FloatingBaseState(
        base_twist=nu_dot[..., :6],
        joint_velocities=nu_dot[..., 6:],
        base_position=state.base_twist[..., :3],
        base_rotation=so3_baumgarte_rate(
            state.base_rotation, state.base_twist[..., 3:], rho),
        joint_positions=state.joint_velocities,
    )


def make_contact_dynamics(
    tree: KinematicTree,
    contact_params_by_frame: Dict[str, "object"],
    *,
    rho: float = 0.0,
    gravity=GRAVITY,
    mass_matrix_regularization: Optional[torch.Tensor] = None,
):
    """Close the loop with :mod:`blf_tpu_torch.models.contact`: wrenches
    computed from the live frame kinematics.

    ``contact_params_by_frame``: frame name -> ``ContactParams``. Returns a
    dynamics function ``f(state, null_poses, t)`` where ``null_poses`` maps
    frame name -> (null_rotation, null_position) (the contact model's
    zero-force pose, typically the planned foothold); no joint torques.
    """
    def dynamics(state: FloatingBaseState, null_poses, t=0.0) -> FloatingBaseState:
        poses = forward_kinematics(
            tree, state.base_position, state.base_rotation, state.joint_positions)
        nu = torch.cat([state.base_twist, state.joint_velocities], dim=-1)
        wrenches = {}
        for frame_name, cparams in contact_params_by_frame.items():
            R_f, p_f, v_f = frame_kinematics(tree, poses, frame_name, nu)
            R0, p0 = null_poses[frame_name]
            wrenches[frame_name] = contact_wrench(
                cparams, ContactState(
                    position=p_f, rotation=R_f,
                    linear_velocity=v_f[..., :3], angular_velocity=v_f[..., 3:],
                    null_position=p0, null_rotation=R0))
        inp = FloatingBaseInput(
            joint_torques=torch.zeros_like(state.joint_positions),
            contact_wrenches=wrenches)
        return floating_base_dynamics(
            tree, state, inp, t, rho=rho, gravity=gravity,
            mass_matrix_regularization=mass_matrix_regularization)

    return dynamics
