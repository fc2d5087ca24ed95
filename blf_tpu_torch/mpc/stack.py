"""Hierarchical control stack: DCM-MPC outer loop, whole-body QP inner loop,
estimators in the loop (BASELINE config 4 in full).

Counterpart of ``blf_tpu/mpc/stack.py``; everything of it is ported. One
outer tick, for every lane of a fleet::

    outer tick (MPC rate, 10 Hz)
      |- measure: CoM/DCM from the plant state (xi = c + cdot / w)
      |- freeze the RLS push estimate for this tick (fed to the WBC model)
      |- plan: shared-operator DCM-MPC from the measured DCM
      |- plant M^-1 (lagged, once a tick) and the ROS2-W stage operator
      '- inner ticks (WBC rate, 100 Hz), a Python loop:
           |- instantaneous DCM controller + integral on the DCM error
           |- whole-body QP (with the estimated push in its dynamics)
           |- plant: rigid-body dynamics, spring-damper soles and the TRUE
           |    (unknown) push; stiff ROS2-W substeps or explicit RK4
           |- momentum observer on (sampled state, commanded torques)
           '- wrench attribution to the push frame (an SPD solve) + RLS

Where the reference vmaps single-lane programs, everything here takes the
fleet as the leading axis of every field of :class:`StackState` (and of the
per-lane pushes); references and polygons are shared. ``lax.scan`` over
inner ticks is a Python loop. Backends: ``"torch"`` is the reference's
``"xla"``, ``"cuda"`` its ``"pallas"`` (WBC, ``solve_qp_lanes`` on K2 and K3)
and ``"pallas_f32"`` (MPC, the exact-f32 shared-operator kernel K1); the MPC
also takes ``"cuda_split"`` and ``"cuda_delta"`` (K1's tensor-core kernel, the
reference's ``"pallas_split"`` and its bf16 ``delta`` mode ``"pallas"``, which
``STACK_r05.json`` ran). As in the reference, the fleet
step's lagged plant M^-1 always goes through K3 and its attribution solve
through K4 (``spd_solve_lane``), whatever the backends say.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from blf_tpu_torch.estimators.rls import RLSParams, RLSState, rls_step
from blf_tpu_torch.estimators.wrench_observer import (
    MomentumObserverParams, MomentumObserverState, init_momentum_observer,
    momentum_observer_step, wrench_normal_equations, wrenches_from_residual)
from blf_tpu_torch.models import rigid_body as rb
from blf_tpu_torch.models.contact import ContactParams, ContactState, contact_wrench
from blf_tpu_torch.models.kinematics import (KinematicTree, forward_kinematics,
                                             frame_jacobian)
from blf_tpu_torch.models.lipm import LIPMParams, lipm_omega
from blf_tpu_torch.mpc.dcm import solve_dcm_mpc
from blf_tpu_torch.mpc.qp import solve_qp
from blf_tpu_torch.mpc.wholebody import (WholeBodyParams, WholeBodyTask,
                                         build_wholebody_qp)
from blf_tpu_torch.ops.cuda.linalg import cholesky_inverse_lane, spd_solve_lane
from blf_tpu_torch.ops.integrators import (integrate, integrate_rosenbrock,
                                           rosenbrock_operator)
from blf_tpu_torch.ops.lie import so3_baumgarte_rate, so3_log
from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.utils.profiling import trace
from blf_tpu_torch.utils.status import SolverStatus, nan_quarantine

__all__ = ["StackConfig", "StackState", "StackTrace", "init_stack",
           "make_stack_step", "make_fleet_stack_step", "PARTS"]

#: the parts of an outer tick, each a span ``stack.<part>``
#: (:func:`blf_tpu_torch.utils.profiling.trace`)
PARTS = ("mpc", "operator", "wbc_build", "wbc_solve", "plant", "estimate")


class StackConfig(NamedTuple):
    """Static configuration of the hierarchical controller (the reference's
    fields and defaults; backends ``"torch"`` / ``"cuda"``)."""

    mpc_dt: float = 0.1             # outer replan period [s]
    horizon: int = 16               # MPC knots
    wbc_per_mpc: int = 10           # inner ticks per outer tick (-> 100 Hz)
    physics_per_wbc: int = 40       # plant substeps per inner tick: RK4 needs
                                    # ~0.25 ms (40) for the light foot links,
                                    # the L-stable "rosenbrock" plant 2-4
    plant_method: str = "rk4"       # "rk4" (explicit) or "rosenbrock" (stiff
                                    # ROS2-W, one lagged stage operator per
                                    # OUTER tick)
    ground_sag: float = 2e-3        # static ground compression per foot [m]
    mpc_iterations: int = 60
    wbc_iterations: int = 250
    wbc_check_every: int = 25       # ADMM stage length (rho-adaptation cadence)
    wbc_polish_iters: int = 0       # low-rho dual-polish tail (solve_qp)
    dcm_gain: float = 1.2           # k_xi of the instantaneous DCM controller
    dcm_ki: float = 0.06            # integral gain on the DCM error [1/s]
    dcm_int_limit: float = 0.06     # anti-windup clamp on the integral [m]
    height_kp: float = 100.0
    height_kd: float = 20.0
    base_kp: float = 60.0           # base-orientation restoring gain
    base_kd: float = 15.0
    posture_kp: float = 100.0
    posture_kd: float = 20.0
    observer_gain: float = 60.0     # momentum-residual bandwidth [rad/s]
    rls_lambda: float = 0.97
    rls_noise: float = 1e-2
    compensate_push: bool = True    # feed the estimate into the WBC model
    wbc_eps: Optional[float] = None  # WBC tolerance; None -> 1e-5 in f64,
    #                                  1e-4 in f32
    mpc_backend: str = "torch"      # fleet step only: "torch", "cuda" (K1, f32),
    #                                 "cuda_split" or "cuda_delta" (K1, tensor cores)
    wbc_backend: str = "torch"      # fleet step only: "torch" or "cuda" (K2, K3)
    wbc_scaling_iters: int = 10     # Ruiz rounds per WBC solve
    plant_lagged_minv: bool = False  # fleet step only: per-tick plant M^-1
    #   (K3) + 2 refinement passes against the exact per-substep M
    ros_op_stiff: bool = False      # fleet step only (requires
    #   plant_lagged_minv): stage operator from the stiff sole-ground path
    #   only (frozen contact Jacobians, lagged M^-1)


class StackState(NamedTuple):
    """Everything the closed loop carries tick to tick; the fleet axis leads
    every field."""

    plant: rb.FloatingBaseState
    observer: MomentumObserverState
    push_theta: torch.Tensor        # (..., 2) RLS xy push-force estimate [N]
    push_cov: torch.Tensor          # (..., 2, 2)
    warm_zmp: torch.Tensor          # (..., N, 2) previous MPC plan
    warm_y: torch.Tensor            # (..., M) previous MPC duals
    warm_s: torch.Tensor            # (..., 1) adapted ADMM rho multiplier
    warm_wbc_x: torch.Tensor        # (..., nx) previous WBC primal
    warm_wbc_y: torch.Tensor        # (..., mw) previous WBC duals
    warm_wbc_s: torch.Tensor        # (..., 1) adapted WBC rho multiplier
    dcm_int: torch.Tensor           # (..., 2) DCM-error integral [m]


class StackTrace(NamedTuple):
    """Per-outer-tick diagnostics, one row a lane."""

    dcm: torch.Tensor               # (..., 2) measured DCM at tick start
    com: torch.Tensor               # (..., 3)
    zmp_cmd: torch.Tensor           # (..., 2) last inner tick's commanded ZMP
    push_estimate: torch.Tensor     # (..., 2) RLS estimate fed to the controller
    mpc_converged: torch.Tensor     # (...,) bool
    wbc_converged: torch.Tensor     # (...,) bool: every inner tick converged
    wbc_max_rp: torch.Tensor        # (...,) worst inner-tick primal residual
    wbc_max_rd: torch.Tensor        # (...,) worst inner-tick dual residual
    status: torch.Tensor            # (...,) int32 SolverStatus: worst of MPC /
    #   WBC / plant finiteness; NUMERICAL_ERROR lanes are quarantined (reset
    #   to the pre-tick state with cleared warm starts)


def _com_state(tree, lipm, state):
    poses = forward_kinematics(tree, state.base_position, state.base_rotation,
                               state.joint_positions)
    com = rb.com_position(tree, poses)
    nu = torch.cat([state.base_twist, state.joint_velocities], dim=-1)
    com_vel = rb.com_velocity(tree, poses, nu)
    dcm = com[..., :2] + com_vel[..., :2] / lipm_omega(lipm)
    return com, com_vel, dcm


def init_stack(
    tree: KinematicTree,
    lipm: LIPMParams,
    config: StackConfig,
    plant: rb.FloatingBaseState,
    num_constraints: int,
    num_contacts: int = 2,
) -> StackState:
    """Stack state at rest for the lanes of ``plant`` (any leading axes):
    observer seeded at p(0), zero push estimate, zero MPC and WBC warm starts
    (``num_contacts`` sizes the WBC vectors, see
    :mod:`blf_tpu_torch.mpc.wholebody`)."""
    q = plant.joint_positions
    batch, new = tuple(q.shape[:-1]), dict(dtype=q.dtype, device=q.device)
    _, obs = init_momentum_observer(tree, plant, config.observer_gain,
                                    config.mpc_dt / config.wbc_per_mpc)
    n, nv, C = tree.num_dofs, tree.nv, num_contacts
    nx = nv + 6 * C + n
    mw = nv + 6 * C + 11 * C + n
    return StackState(
        plant=plant,
        observer=obs,
        push_theta=torch.zeros(batch + (2,), **new),
        push_cov=(torch.eye(2, **new) * 1e2).expand(batch + (2, 2)).clone(),
        warm_zmp=torch.zeros(batch + (config.horizon, 2), **new),
        warm_y=torch.zeros(batch + (num_constraints,), **new),
        warm_s=torch.ones(batch + (1,), **new),
        warm_wbc_x=torch.zeros(batch + (nx,), **new),
        warm_wbc_y=torch.zeros(batch + (mw,), **new),
        warm_wbc_s=torch.ones(batch + (1,), **new),
        dcm_int=torch.zeros(batch + (2,), **new),
    )


def _default_ground(tree, wbc_params, config):
    """Spring-damper ground under each sole: k sized for ``config.ground_sag``
    static compression per foot, damping 0.4 of critical on the body's
    vertical mode. Plain numbers: they broadcast into any dtype and device."""
    total_mass = float(tree.total_mass)
    n_feet = max(1, len(wbc_params.contact_frames))
    L, W = 2 * wbc_params.foot_half_length, 2 * wbc_params.foot_half_width
    per_foot = total_mass * 9.81 / n_feet
    k_eff = per_foot / config.ground_sag
    c_eff = 0.8 * (k_eff * total_mass / n_feet) ** 0.5
    return {f: ContactParams(L, W, k_eff / (L * W), c_eff / (L * W))
            for f in wbc_params.contact_frames}


def _apply_t(J, w):
    """``J' w`` over leading axes: (..., 6, nv), (..., 6) -> (..., nv)."""
    return torch.einsum("...ij,...i->...j", J, w)


def _plant_functions(tree, ground, null_poses, push_frame):
    """``(ground_wrenches, fdyn, fdyn_stiff)``: the stance frames' spring-damper
    reactions (the foot F/T readings of the estimator chain), the
    contact-closed plant dynamics with the (unknown) push wrench applied at
    ``push_frame``, and the stiff sole-ground path alone for the ROS2-W stage
    operator."""

    def ground_wrenches(plant, poses):
        nu = torch.cat([plant.base_twist, plant.joint_velocities], dim=-1)
        out = {}
        for fname, cparams in ground.items():
            R_f, p_f, v_f = rb.frame_kinematics(tree, poses, fname, nu)
            R0, p0 = null_poses[fname]
            out[fname] = contact_wrench(cparams, ContactState(
                position=p_f, rotation=R_f,
                linear_velocity=v_f[..., :3], angular_velocity=v_f[..., 3:],
                null_position=p0, null_rotation=R0))
        return out

    def fdyn(s, tau, t, push_w, minv=None):
        poses_s = forward_kinematics(
            tree, s.base_position, s.base_rotation, s.joint_positions)
        wrenches_s = ground_wrenches(s, poses_s)
        wrenches_s[push_frame] = push_w
        return rb.floating_base_dynamics(
            tree, s, rb.FloatingBaseInput(joint_torques=tau,
                                          contact_wrenches=wrenches_s),
            t, rho=1.0, minv=minv)

    def fdyn_stiff(s, minv, jac_frozen):
        """Reduced dynamics for the stage operator only (never integrated):
        kinematic rows exact; ``nudot = M^-1 sum J_frozen' w_c(x)``, the
        sole-ground path whose ~3e3/s modes the operator must capture.
        ``jac_frozen`` maps frame name -> (..., 6, nv) tick-start Jacobian;
        a ground frame it lacks raises ``KeyError``, as in the reference."""
        poses_s = forward_kinematics(
            tree, s.base_position, s.base_rotation, s.joint_positions)
        wrenches_s = ground_wrenches(s, poses_s)
        tau_gen = sum(_apply_t(jac_frozen[f], wrenches_s[f]) for f in ground)
        nu_dot = torch.einsum("...ij,...j->...i", minv, tau_gen)
        return rb.FloatingBaseState(
            base_twist=nu_dot[..., :6],
            joint_velocities=nu_dot[..., 6:],
            base_position=s.base_twist[..., :3],
            base_rotation=so3_baumgarte_rate(
                s.base_rotation, s.base_twist[..., 3:], 1.0),
            joint_positions=s.joint_velocities,
        )

    return ground_wrenches, fdyn, fdyn_stiff


@functools.lru_cache(maxsize=None)
def _tensors(config: StackConfig, dtype, device):
    """The loop's constant tensors, made once per (config, dtype, device)."""
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    wbc_dt = config.mpc_dt / config.wbc_per_mpc
    eye2 = torch.eye(2, dtype=dtype, device=device)
    return (MomentumObserverParams(gain=as_t(config.observer_gain), dt=as_t(wbc_dt)),
            RLSParams(lam=as_t(config.rls_lambda),
                      measurement_covariance=config.rls_noise * eye2),
            eye2)


def _make_step(tree, wbc_params, lipm, config, null_poses, *, ground, push_frame,
               q_ref, com_height_ref, attribution):
    omega = lipm_omega(lipm)
    wbc_dt = config.mpc_dt / config.wbc_per_mpc
    physics_dt = wbc_dt / config.physics_per_wbc
    if ground is None:
        ground = _default_ground(tree, wbc_params, config)
    ground_wrenches, fdyn, fdyn_stiff = _plant_functions(
        tree, ground, null_poses, push_frame)
    nv, C = tree.nv, len(wbc_params.contact_frames)
    if config.plant_method not in ("rk4", "rosenbrock"):
        raise ValueError(f"unknown plant_method {config.plant_method!r}")
    if config.plant_method == "rosenbrock" and config.ros_op_stiff \
            and not config.plant_lagged_minv:
        raise ValueError("ros_op_stiff requires plant_lagged_minv")

    @torch.no_grad()
    @f32_matmuls
    def step(stack: StackState, true_push_xy, dcm_ref, zmp_ref, poly_A, poly_b
             ) -> Tuple[StackState, StackTrace]:
        q0 = stack.plant.joint_positions
        dtype, device = q0.dtype, q0.device
        B = q0.shape[0]
        new = dict(dtype=dtype, device=device)
        obs_params, rls_params, eye2 = _tensors(config, dtype, device)
        com0, _, dcm0 = _com_state(tree, lipm, stack.plant)
        # the outer tick's frozen push estimate feeds the WBC model
        ext_w = (torch.cat([stack.push_theta, torch.zeros((B, 4), **new)], dim=-1)
                 if config.compensate_push
                 else torch.zeros((B, 6), **new))[:, None, :]      # (B, 1, 6)

        with trace("stack.mpc"):
            plan = solve_dcm_mpc(
                lipm, config.mpc_dt, dcm0, com0[:, :2], dcm_ref, zmp_ref,
                poly_A, poly_b, iterations=config.mpc_iterations,
                warm_start=stack.warm_zmp, warm_start_dual=stack.warm_y,
                s0=stack.warm_s, shared=True, backend=config.mpc_backend)

        height_ref = torch.as_tensor(
            com_height_ref if com_height_ref is not None else lipm.com_height, **new)
        posture_ref = q0 if q_ref is None else torch.as_tensor(q_ref, **new)
        push_wrench = torch.cat([true_push_xy, torch.zeros((B, 4), **new)], dim=-1)

        with trace("stack.operator"):
            minv_tick = None
            if config.plant_lagged_minv:
                # per-tick plant M^-1 on K3; fdyn refines it against the
                # exact per-substep M
                p = stack.plant
                minv_tick = cholesky_inverse_lane(rb.mass_matrix(
                    tree, p.base_position, p.base_rotation, p.joint_positions
                ).contiguous())                                      # (B, nv, nv)
            ros_op = None
            if config.plant_method == "rosenbrock":
                zero_tau = torch.zeros_like(q0)
                if config.ros_op_stiff:
                    p = stack.plant
                    poses_p = forward_kinematics(
                        tree, p.base_position, p.base_rotation, p.joint_positions)
                    jfro = {f: frame_jacobian(tree, poses_p, f)
                            for f in wbc_params.contact_frames}
                    ros_op = rosenbrock_operator(
                        lambda s, u_, t_: fdyn_stiff(s, minv_tick, jfro),
                        p, u=zero_tau, dt=physics_dt)
                else:
                    ros_op = rosenbrock_operator(
                        lambda s, tau, t: fdyn(s, tau, t, push_wrench, minv=minv_tick),
                        stack.plant, u=zero_tau, dt=physics_dt)    # (B, D, D)

        def f_lane(s, tau, t):
            return fdyn(s, tau, t, push_wrench, minv=minv_tick)

        eps = config.wbc_eps if config.wbc_eps is not None else (
            1e-5 if torch.finfo(dtype).bits >= 64 else 1e-4)

        plant, obs = stack.plant, stack.observer
        theta, cov = stack.push_theta, stack.push_cov
        x_w, y_w, s_w, dcm_i = (stack.warm_wbc_x, stack.warm_wbc_y,
                                stack.warm_wbc_s, stack.dcm_int)
        z_cmds, wbc_conv, wbc_rps, wbc_rds = [], [], [], []
        for k in range(config.wbc_per_mpc):
            with trace("stack.wbc_build"):
                com, com_vel, dcm = _com_state(tree, lipm, plant)
                frac = (k + 1.0) / config.wbc_per_mpc
                dcm_ref_now = plan.dcm[:, 0] + frac * (plan.dcm[:, 1] - plan.dcm[:, 0])
                dcm_i = torch.clamp(
                    dcm_i + config.dcm_ki * wbc_dt * (dcm - dcm_ref_now),
                    -config.dcm_int_limit, config.dcm_int_limit)
                z_cmd = (plan.zmp[:, 0] + (1.0 + config.dcm_gain / omega)
                         * (dcm - dcm_ref_now) + dcm_i)
                com_acc_xy = omega ** 2 * (com[:, :2] - z_cmd)
                com_acc_z = (config.height_kp * (height_ref - com[:, 2])
                             - config.height_kd * com_vel[:, 2])
                task = WholeBodyTask(
                    com_acc_des=torch.cat([com_acc_xy, com_acc_z[:, None]], dim=-1),
                    base_ang_acc_des=(-config.base_kp * so3_log(plant.base_rotation)
                                      - config.base_kd * plant.base_twist[:, 3:]),
                    posture_acc_des=(config.posture_kp * (posture_ref - plant.joint_positions)
                                     - config.posture_kd * plant.joint_velocities),
                    contact_active=torch.ones((B, C), **new),
                    ext_wrench=ext_w,
                )
                qp = build_wholebody_qp(tree, wbc_params, plant, task, (push_frame,))
            with trace("stack.wbc_solve"):
                sol = solve_qp(*qp, iterations=config.wbc_iterations,
                               x0=x_w, y0=y_w, s0=s_w,
                               check_every=config.wbc_check_every,
                               polish_iters=config.wbc_polish_iters,
                               scaling_iters=config.wbc_scaling_iters,
                               eps_abs=eps, eps_rel=eps, backend=config.wbc_backend)
            torques = sol.x[:, nv + 6 * C:]

            with trace("stack.plant"):
                if config.plant_method == "rosenbrock":
                    plant_next = integrate_rosenbrock(
                        f_lane, plant, dt=physics_dt, num_steps=config.physics_per_wbc,
                        u=torques, operator=ros_op)
                else:
                    plant_next = integrate(
                        f_lane, plant, dt=physics_dt, num_steps=config.physics_per_wbc,
                        u=torques, method="rk4")

            with trace("stack.estimate"):
                # the soles' F/T readings are known generalized force: only
                # the remainder of the residual is attributed to the push frame
                obs, residual = momentum_observer_step(
                    tree, obs_params, obs, plant_next, torques)
                poses_next = forward_kinematics(
                    tree, plant_next.base_position, plant_next.base_rotation,
                    plant_next.joint_positions)
                ft_meas = ground_wrenches(plant_next, poses_next)
                tau_known = sum(
                    _apply_t(frame_jacobian(tree, poses_next, f), ft_meas[f])
                    for f in wbc_params.contact_frames)
                if attribution == "kernel":
                    G, Jr = wrench_normal_equations(
                        tree, plant_next, (push_frame,), residual - tau_known)
                    push_meas = spd_solve_lane(G.contiguous(), Jr.contiguous())[:, :2]
                else:
                    push_meas = wrenches_from_residual(
                        tree, plant_next, (push_frame,), residual - tau_known)[:, -1, :2]
                est = rls_step(rls_params, RLSState(theta, cov), eye2, push_meas)
            plant, theta, cov = plant_next, est.theta, est.covariance
            x_w, y_w, s_w = sol.x, sol.y, sol.rho_scale
            z_cmds.append(z_cmd)
            wbc_conv.append(sol.converged)
            wbc_rps.append(sol.primal_residual)
            wbc_rds.append(sol.dual_residual)

        wbc_conv = torch.stack(wbc_conv)                           # (K, B)
        wbc_rps, wbc_rds = torch.stack(wbc_rps), torch.stack(wbc_rds)
        new_stack = StackState(
            plant=plant, observer=obs, push_theta=theta, push_cov=cov,
            warm_zmp=plan.zmp, warm_y=plan.qp.y, warm_s=plan.qp.rho_scale,
            warm_wbc_x=x_w, warm_wbc_y=y_w, warm_wbc_s=s_w, dcm_int=dcm_i)

        # per-lane status (worst of MPC / WBC / plant finiteness) + NaN
        # quarantine, as the fleet tick (parallel/sweep.py)
        plant_finite = torch.stack(
            [torch.isfinite(leaf).reshape(B, -1).all(dim=-1) for leaf in plant]
        ).all(dim=0)
        wbc_finite = (torch.isfinite(wbc_rps).all(dim=0)
                      & torch.isfinite(wbc_rds).all(dim=0))
        wbc_all_conv = wbc_conv.all(dim=0)
        numerical = ~plant_finite | ~wbc_finite
        status = torch.where(
            numerical, int(SolverStatus.NUMERICAL_ERROR),
            torch.where(wbc_all_conv & plan.qp.converged, int(SolverStatus.CONVERGED),
                        int(SolverStatus.MAX_ITERATIONS))).to(torch.int32)
        reset = StackState(
            plant=stack.plant, observer=stack.observer,
            push_theta=torch.zeros_like(stack.push_theta),
            push_cov=(torch.eye(2, **new) * 1e2).expand_as(stack.push_cov),
            warm_zmp=torch.zeros_like(stack.warm_zmp),
            warm_y=torch.zeros_like(stack.warm_y),
            warm_s=torch.ones_like(stack.warm_s),
            warm_wbc_x=torch.zeros_like(stack.warm_wbc_x),
            warm_wbc_y=torch.zeros_like(stack.warm_wbc_y),
            warm_wbc_s=torch.ones_like(stack.warm_wbc_s),
            dcm_int=torch.zeros_like(stack.dcm_int))
        new_stack = nan_quarantine(new_stack, status, reset)

        return new_stack, StackTrace(
            dcm=dcm0, com=com0, zmp_cmd=z_cmds[-1], push_estimate=stack.push_theta,
            mpc_converged=plan.qp.converged, wbc_converged=wbc_all_conv,
            wbc_max_rp=wbc_rps.amax(dim=0), wbc_max_rd=wbc_rds.amax(dim=0),
            status=status)

    return step


def make_fleet_stack_step(
    tree: KinematicTree,
    wbc_params: WholeBodyParams,
    lipm: LIPMParams,
    config: StackConfig,
    null_poses,
    *,
    ground: Optional[dict] = None,
    push_frame: str = "imu",
    q_ref: Optional[torch.Tensor] = None,
    com_height_ref: Optional[float] = None,
):
    """The fleet outer tick: ``step(states, pushes, dcm_ref, zmp_ref, poly_A,
    poly_b) -> (StackState, StackTrace)``, with the fleet on the leading axis
    of every field of ``states`` and of ``pushes`` (B, 2), the UNKNOWN constant
    horizontal forces at ``push_frame``; references and polygons are shared.

    The plant is grounded through the spring-damper contact model:
    ``null_poses`` maps each stance frame to its zero-force pose ``(R0, p0)``;
    ``ground`` optionally overrides the per-frame :class:`ContactParams`
    (default: a patch of the WBC sole with ``config.ground_sag`` static
    compression). The WBC's torques drive the plant; the ground reaction
    emerges from the contact dynamics and plays the soles' F/T sensors.

    Both QP solves are single batched calls: ``config.mpc_backend`` routes the
    DCM-MPC (``"cuda"``: K1; ``"cuda_split"``/``"cuda_delta"``: its
    tensor-core kernel), ``config.wbc_backend`` the WBC (``"cuda"``:
    ``solve_qp_lanes`` on K2 and K3). ``plant_lagged_minv`` inverts the plant's
    mass matrix once a tick on K3; ``ros_op_stiff`` builds the ROS2-W operator
    from the stiff path alone. The attribution solve runs through
    ``spd_solve_lane`` (K4) in every configuration.
    """
    return _make_step(tree, wbc_params, lipm, config, null_poses, ground=ground,
                      push_frame=push_frame, q_ref=q_ref,
                      com_height_ref=com_height_ref, attribution="kernel")


def make_stack_step(
    tree: KinematicTree,
    wbc_params: WholeBodyParams,
    lipm: LIPMParams,
    config: StackConfig,
    null_poses,
    *,
    ground: Optional[dict] = None,
    push_frame: str = "imu",
    q_ref: Optional[torch.Tensor] = None,
    com_height_ref: Optional[float] = None,
):
    """The per-lane outer tick, with the semantics of the reference's
    ``make_stack_step`` under ``vmap``: the same signature and loop as
    :func:`make_fleet_stack_step`, but both QPs solved on ``"torch"``
    (``solve_qp``'s batched Cholesky path; the MPC backend, the WBC backend,
    ``plant_lagged_minv`` and ``ros_op_stiff`` are fleet-step options and
    ignored here), the ROS2-W operator from the full dynamics, and the
    attribution solved densely (``wrenches_from_residual``)."""
    config = config._replace(mpc_backend="torch", wbc_backend="torch",
                             plant_lagged_minv=False, ros_op_stiff=False)
    return _make_step(tree, wbc_params, lipm, config, null_poses, ground=ground,
                      push_frame=push_frame, q_ref=q_ref,
                      com_height_ref=com_height_ref, attribution="dense")
