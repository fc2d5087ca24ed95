"""Whole-body tracking QP: the 100 Hz inner loop of the control stack.

Counterpart of ``blf_tpu/mpc/wholebody.py``; everything of it is ported.
Task-space inverse dynamics as one strictly convex QP per control tick,
solved by the batched ADMM of :mod:`blf_tpu_torch.mpc.qp` so thousands of
scenario instances run per device. Decision vector (via the
``VariablesHandler`` registry):

    x = [nudot (6+n) | f_c (6 per contact frame) | tau (n)]

Equality rows:
- floating-base dynamics ``M nudot - sum J_c' f_c - S tau = -h``, the balance
  the forward dynamics solves, used here in its inverse-dynamics direction;
- per contact frame, EITHER the stance constraint
  ``J_c nudot = -Jdot_c nu - k_d J_c nu`` (acceleration-level,
  velocity-damped) OR ``f_c = 0`` when inactive, blended by an activation
  mask so that the contact schedule never changes a shape.

Inequality rows (per contact): unilateral ``f_z >= 0``, linearized friction
pyramid ``|f_xy| <= mu f_z``, CoP inside the sole rectangle
``|tau_y| <= (L/2) f_z``, ``|tau_x| <= (W/2) f_z``, yaw friction
``|tau_z| <= mu_z f_z``; plus joint torque limits.

Cost: CoM linear-acceleration tracking, base angular-acceleration tracking,
joint posture acceleration tracking, and force/torque regularisation.

Where the reference is single-sample and ``vmap``-ped, every function here
takes the batch as leading dimensions of the state and the task, and works
unbatched too. For the 23-DoF humanoid on two soles the QP has n = 64
unknowns and m = 86 rows a lane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from blf_tpu_torch.models import rigid_body as rb
from blf_tpu_torch.models.kinematics import (KinematicTree, forward_kinematics,
                                             frame_jacobian)
from blf_tpu_torch.mpc.qp import QPSolution, solve_qp
from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.planners.variables import VariablesHandler

__all__ = ["WholeBodyParams", "WholeBodyTask", "WholeBodySolution",
           "make_variables", "build_wholebody_qp", "solve_wholebody_qp"]


class WholeBodyParams(NamedTuple):
    """Static controller parameters."""

    contact_frames: Tuple[str, ...]
    friction_mu: float = 0.7
    torsional_mu: float = 0.05
    foot_half_length: float = 0.07
    foot_half_width: float = 0.04
    torque_limit: float = 60.0
    stance_damping: float = 20.0      # k_d on the stance velocity residual
    # Task weights: the CoM task must DOMINATE the posture block, or the
    # weighted trade-off leaves a push-proportional realized-CoP gap.
    # Posture and orientation remain regularized, not traded against the
    # balance-critical task.
    w_com: float = 300.0
    w_base_ang: float = 5.0
    w_posture: float = 0.1
    w_force_reg: float = 1e-4
    w_torque_reg: float = 1e-4


class WholeBodyTask(NamedTuple):
    """Per-tick tracking targets (from the outer loop and a posture PD)."""

    com_acc_des: torch.Tensor        # (..., 3)
    base_ang_acc_des: torch.Tensor   # (..., 3)
    posture_acc_des: torch.Tensor    # (..., n)
    contact_active: torch.Tensor     # (..., C) float/bool mask
    ext_wrench: Optional[torch.Tensor] = None  # (..., E, 6) estimated external
    #   wrenches at ``ext_frames`` (see build_wholebody_qp): modeled in the
    #   dynamics equality so that the inverse dynamics realizes the commanded
    #   accelerations UNDER the disturbance.


class WholeBodySolution(NamedTuple):
    nu_dot: torch.Tensor             # (..., 6+n)
    wrenches: torch.Tensor           # (..., C, 6)
    torques: torch.Tensor            # (..., n)
    qp: QPSolution


def make_variables(tree: KinematicTree, num_contacts: int) -> VariablesHandler:
    handler = VariablesHandler()
    handler.add_variable("nu_dot", tree.nv)
    for c in range(num_contacts):
        handler.add_variable(f"wrench_{c}", 6)
    handler.add_variable("tau", tree.num_dofs)
    return handler


def _cone(params: WholeBodyParams, dtype, device) -> torch.Tensor:
    mu, muz = params.friction_mu, params.torsional_mu
    hl, hw = params.foot_half_length, params.foot_half_width
    return torch.tensor(
        [
            [0, 0, -1.0, 0, 0, 0],          # -f_z <= 0
            [1, 0, -mu, 0, 0, 0],           # f_x - mu f_z <= 0
            [-1, 0, -mu, 0, 0, 0],
            [0, 1, -mu, 0, 0, 0],
            [0, -1, -mu, 0, 0, 0],
            [0, 0, -hl, 0, 1.0, 0],         # tau_y - (L/2) f_z <= 0
            [0, 0, -hl, 0, -1.0, 0],
            [0, 0, -hw, 1.0, 0, 0],         # tau_x - (W/2) f_z <= 0
            [0, 0, -hw, -1.0, 0, 0],
            [0, 0, -muz, 0, 0, 1.0],        # tau_z - mu_z f_z <= 0
            [0, 0, -muz, 0, 0, -1.0],
        ],
        dtype=dtype, device=device)                       # (11, 6)


@f32_matmuls
def build_wholebody_qp(
    tree: KinematicTree,
    params: WholeBodyParams,
    state: rb.FloatingBaseState,
    task: WholeBodyTask,
    ext_frames: Tuple[str, ...] = (),
):
    """Assemble (P, q, A, l, u) for one whole-body tick, for every lane of the
    state's leading batch axes: ``P`` (..., nx, nx), ``q`` (..., nx), ``A``
    (..., m, nx), ``l``/``u`` (..., m).

    ``ext_frames`` names the frames whose ESTIMATED external wrenches
    ``task.ext_wrench`` (rows matching) enter the dynamics equality:
    ``M nudot - sum J_c' f_c - S tau = -h + sum J_e' w_e``: the estimator
    feeding the controller's *model*, not just its reference shift.
    """
    n = tree.num_dofs
    nv = tree.nv
    C = len(params.contact_frames)
    q_pos = state.joint_positions
    dtype, device = q_pos.dtype, q_pos.device
    batch = tuple(q_pos.shape[:-1])
    nx = nv + 6 * C + n
    new = dict(dtype=dtype, device=device)
    block = lambda t: t.expand(batch + tuple(t.shape))    # constant rows, every lane
    zeros = lambda *shape: torch.zeros(batch + shape, **new)

    poses = forward_kinematics(
        tree, state.base_position, state.base_rotation, q_pos)
    nu = torch.cat([state.base_twist, state.joint_velocities], dim=-1)
    M = rb.mass_matrix(tree, state.base_position, state.base_rotation, q_pos, poses)
    h = rb.bias_forces(tree, state.base_position, state.base_rotation, q_pos,
                       state.base_twist, state.joint_velocities, poses=poses)

    Jc = [frame_jacobian(tree, poses, f) for f in params.contact_frames]  # (..., 6, nv)
    jdot_nu = [
        rb.frame_bias_acceleration(
            tree, state.base_position, state.base_rotation, q_pos,
            state.base_twist, state.joint_velocities, f)
        for f in params.contact_frames
    ]                                                                     # (..., 6)
    active = torch.as_tensor(task.contact_active, **new)                  # (..., C)

    # -- equality rows -------------------------------------------------------
    # dynamics: [M | -J_0' ... -J_{C-1}' | -S] x = -h
    eye_n = torch.eye(n, **new)
    S = torch.cat([torch.zeros((6, n), **new), eye_n], dim=0)             # (nv, n)
    dyn = torch.cat([M] + [-J.transpose(-1, -2) for J in Jc] + [block(-S)], dim=-1)
    dyn_rhs = -h
    for e, fname in enumerate(ext_frames):
        dyn_rhs = dyn_rhs + torch.einsum(
            "...ij,...i->...j", frame_jacobian(tree, poses, fname),
            torch.as_tensor(task.ext_wrench, **new)[..., e, :])

    # contact blocks: active -> J nudot = -Jdot nu - k_d J nu on acceleration;
    # inactive -> f = 0. Same 6-row shape, blended by the mask.
    eye6 = torch.eye(6, **new)
    eq_blocks, eq_rhs = [], []
    for c in range(C):
        a = active[..., c, None]                                          # (..., 1)
        stance_rows = torch.cat([Jc[c], zeros(6, 6 * C + n)], dim=-1)
        force_rows = torch.nn.functional.pad(
            eye6, (nv + 6 * c, nx - nv - 6 * (c + 1)))                    # (6, nx)
        stance_rhs = -jdot_nu[c] - params.stance_damping * torch.einsum(
            "...ij,...j->...i", Jc[c], nu)
        eq_blocks.append(a[..., None] * stance_rows + (1 - a[..., None]) * force_rows)
        eq_rhs.append(a * stance_rhs)

    A_eq = torch.cat([dyn] + eq_blocks, dim=-2)
    b_eq = torch.cat([dyn_rhs] + eq_rhs, dim=-1)

    # -- inequality rows -----------------------------------------------------
    cone = _cone(params, dtype, device)
    ineq_blocks = [
        torch.nn.functional.pad(cone, (nv + 6 * c, nx - nv - 6 * (c + 1)))
        for c in range(C)
    ]
    tau_rows = torch.nn.functional.pad(eye_n, (nv + 6 * C, 0))
    A_in = torch.cat(ineq_blocks + [tau_rows], dim=0)                     # (11 C + n, nx)
    u_in = torch.cat([torch.zeros(11 * C, **new),
                      torch.full((n,), params.torque_limit, **new)])
    l_in = torch.cat([torch.full((11 * C,), -torch.inf, **new),
                      torch.full((n,), -params.torque_limit, **new)])

    A = torch.cat([A_eq, block(A_in)], dim=-2)
    l = torch.cat([b_eq, block(l_in)], dim=-1)
    u = torch.cat([b_eq, block(u_in)], dim=-1)

    # -- cost ----------------------------------------------------------------
    Jcom = rb.com_jacobian(tree, poses)                                   # (..., 3, nv)
    jdot_com = rb.com_bias_acceleration(
        tree, state.base_position, state.base_rotation, q_pos,
        state.base_twist, state.joint_velocities)
    rows_com = torch.nn.functional.pad(Jcom, (0, nx - nv))
    tgt_com = task.com_acc_des - jdot_com

    rows_ang = torch.nn.functional.pad(torch.eye(3, **new), (3, nx - 6))
    rows_post = torch.nn.functional.pad(eye_n, (6, nx - nv))

    lanes = lambda v: v.expand(batch + tuple(v.shape[-1:]))   # a shared target, every lane
    T = torch.cat([rows_com, block(rows_ang), block(rows_post)], dim=-2)
    t = torch.cat([lanes(tgt_com), lanes(task.base_ang_acc_des),
                   lanes(task.posture_acc_des)], dim=-1)
    w = torch.cat([torch.full((3,), params.w_com, **new),
                   torch.full((3,), params.w_base_ang, **new),
                   torch.full((n,), params.w_posture, **new)])
    Tw = T.transpose(-1, -2) * w                                          # (..., nx, 6+n)
    # regularisers (strict convexity for the force/torque nullspace)
    reg = torch.cat([torch.full((nv,), 1e-6, **new),
                     torch.full((6 * C,), params.w_force_reg, **new),
                     torch.full((n,), params.w_torque_reg, **new)])
    P = Tw @ T + torch.diag(reg)
    qvec = -torch.einsum("...ij,...j->...i", Tw, t)
    return P, qvec, A, l, u


def solve_wholebody_qp(
    tree: KinematicTree,
    params: WholeBodyParams,
    state: rb.FloatingBaseState,
    task: WholeBodyTask,
    *,
    iterations: int = 150,
    x0: Optional[torch.Tensor] = None,
    y0: Optional[torch.Tensor] = None,
    ext_frames: Tuple[str, ...] = (),
    **qp_kwargs,
) -> WholeBodySolution:
    """Build and solve one whole-body tick for every lane. ``qp_kwargs``
    (``backend``, ``check_every``, ``s0``, ``eps_abs``, ...) pass through to
    :func:`blf_tpu_torch.mpc.qp.solve_qp`; ``backend="cuda"`` needs exactly one
    batch axis."""
    nv, C = tree.nv, len(params.contact_frames)
    P, q, A, l, u = build_wholebody_qp(tree, params, state, task, ext_frames)
    sol = solve_qp(P, q, A, l, u, iterations=iterations, x0=x0, y0=y0,
                   **qp_kwargs)
    return WholeBodySolution(
        nu_dot=sol.x[..., :nv],
        wrenches=sol.x[..., nv: nv + 6 * C].reshape(sol.x.shape[:-1] + (C, 6)),
        torques=sol.x[..., nv + 6 * C:],
        qp=sol,
    )
