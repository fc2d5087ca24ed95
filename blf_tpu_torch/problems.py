"""Problem instances of the port's paths, made with numpy from a seed.

Counterparts: ``_example_problem`` of ``__graft_entry__.py`` (a four-step
walking reference), the stationary push-recovery workload that ``bench.py``
builds inline (time-invariant receding horizon, so the warm-started steady
state is the production workload), and the closed whole-body-control loop
that ``tests/test_wholebody.py`` of the JAX package pins
(``TestClosedLoop::test_balance_hold_100hz`` over the perturbed fleet of
``TestBatched``): :func:`standing_fleet` and :func:`wbc_balance_step`; and the
push-recovery fleet of the whole control stack that
``benchmarks/stack_bench.py`` runs: :func:`push_recovery_stack` in the
``STACK_R05`` configuration. BASELINE config 2: the Monte-Carlo foot
rollout of ``benchmarks/rollout_bench.py`` (:func:`foot_drop_fleet`) and the
contact identification of ``examples/02_contact_identification.py`` over a
fleet (:func:`contact_identification_fleet`, :func:`identify_contacts`).
BASELINE config 3: the 10-step gait of ``examples/03_full_gait.py`` over a
fleet of initial DCMs, the sweep of ``tests/test_gait.py``'s
``test_batched_gait_scenarios`` widened (:func:`gait_fleet`). The
time-varying DCM planner of BASELINE's north star over a fleet of pushed
initial DCMs, on ``tests/test_sqp.py``'s push-recovery problem
(:func:`dcm_planner_fleet`).
Inputs are drawn with ``numpy.random.default_rng(seed)``, so the JAX package
and the port can be fed the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from blf_tpu_torch.estimators.rls import RLSState, init_from_handler, rls_scan
from blf_tpu_torch.estimators.rls_parallel import rls_fit, rls_parallel
from blf_tpu_torch.models import contact
from blf_tpu_torch.models import rigid_body as rb
from blf_tpu_torch.models.foot import FootParams, FootState, foot_rollout
from blf_tpu_torch.models.kinematics import (KinematicTree, forward_kinematics,
                                             frame_pose)
from blf_tpu_torch.models.lipm import LIPMParams, dcm_backward_recursion
from blf_tpu_torch.models.robots import HUMANOID_SOLE_FRAMES, make_humanoid_23dof
from blf_tpu_torch.mpc.stack import (StackConfig, StackState, init_stack,
                                     make_fleet_stack_step)
from blf_tpu_torch.mpc.wholebody import (WholeBodyParams, WholeBodySolution,
                                         WholeBodyTask, solve_wholebody_qp)
from blf_tpu_torch.ops.integrators import integrate
from blf_tpu_torch.ops.lie import so3_exp
from blf_tpu_torch.planners.gait import footstep_plan
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype
from blf_tpu_torch.utils.params import ParametersHandler
from blf_tpu_torch.utils.profiling import trace

__all__ = ["example_problem", "PushRecoveryProblem", "stationary_push_recovery",
           "StandingFleet", "WBCWarmStart", "standing_fleet", "balance_task",
           "apply_solution", "wbc_balance_step", "STACK_R05", "PushRecoveryStack",
           "push_recovery_stack", "stack_fleet_step", "FootDropFleet", "foot_drop_fleet",
           "ContactIdentificationFleet", "contact_identification_fleet",
           "Identification", "identify_contacts", "IDENTIFY_PARTS",
           "IDENTIFY_STEPS_PER_SAMPLE", "GaitFleet", "gait_fleet", "GAIT_ITERATIONS",
           "DCMPlannerFleet", "dcm_planner_fleet", "random_lqr_batch"]

_BOX = [[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]


def _lipm(device, dtype) -> LIPMParams:
    return LIPMParams(torch.tensor(0.9, dtype=dtype, device=device),
                      torch.tensor(9.81, dtype=dtype, device=device))


def example_problem(batch: int, horizon: int, *, seed: int = 0, device=None,
                    dtype: Optional[torch.dtype] = None):
    """``(params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b)``: a four-step
    walking reference with per-knot box polygons around the footholds and
    ``batch`` perturbed initial DCMs."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    params = _lipm(device, dtype)
    dt = 0.1
    steps = np.array([[0.0, -0.1], [0.2, 0.1], [0.4, -0.1], [0.6, 0.1]])
    reps = horizon // 4
    zmp_ref = as_t(np.repeat(steps, reps, axis=0)[:horizon])
    dcm_ref = dcm_backward_recursion(params, zmp_ref, as_t(steps[-1]), dt)
    poly_A = as_t(_BOX).repeat(horizon, 1, 1)
    poly_b = torch.stack(
        [zmp_ref[:, 0] + 0.07, -(zmp_ref[:, 0] - 0.07),
         zmp_ref[:, 1] + 0.04, -(zmp_ref[:, 1] - 0.04)], dim=-1)
    rng = np.random.default_rng(seed)
    dcm0 = as_t(np.array([0.05, -0.08]) + rng.uniform(-0.02, 0.02, (batch, 2)))
    return params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b


class PushRecoveryProblem(NamedTuple):
    """Inputs of the stationary push-recovery fleet tick."""

    params: LIPMParams
    dt: float
    dcm_ref: torch.Tensor      # (N+1, 2)
    zmp_ref: torch.Tensor      # (N, 2)
    poly_A: torch.Tensor       # (N, 4, 2)
    poly_b: torch.Tensor       # (N, 4)
    dcm0: torch.Tensor         # (2,) initial DCM of every lane
    com0: torch.Tensor         # (2,)
    disturbance: torch.Tensor  # (B, K, 2) per-lane push of each ensemble member, N(0, 0.004)
    num_constraints: int       # 2N + 4N rows of the transcription


def stationary_push_recovery(batch: int, horizon: int, *, seed: int = 0, ensemble: int = 1,
                             device=None, dtype: Optional[torch.dtype] = None
                             ) -> PushRecoveryProblem:
    """The fleet workload: every lane stands on one stance (references at the
    origin, a 0.2 m x 0.12 m support box), starts at DCM = CoM =
    (0.01, -0.01) and is pushed by its own draw of N(0, 0.004) each tick.

    ``ensemble``: the K push realizations of a disturbance ensemble, one
    seeded draw a member (member k from seed ``seed + k``), so member 0 is
    the draw of ``ensemble=1``."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    start = as_t([0.01, -0.01])
    return PushRecoveryProblem(
        params=_lipm(device, dtype),
        dt=0.1,
        dcm_ref=torch.zeros((horizon + 1, 2), dtype=dtype, device=device),
        zmp_ref=torch.zeros((horizon, 2), dtype=dtype, device=device),
        poly_A=as_t(_BOX).repeat(horizon, 1, 1),
        poly_b=as_t([0.1, 0.1, 0.06, 0.06]).repeat(horizon, 1),
        dcm0=start,
        com0=start.clone(),
        disturbance=as_t(np.stack(
            [np.random.default_rng(seed + k).normal(0, 0.004, (batch, 2))
             for k in range(ensemble)], axis=1)),
        num_constraints=2 * horizon + 4 * horizon,
    )


# ---------------------------------------------------------------------------
# The whole-body-control loop: a fleet of standing humanoids
# ---------------------------------------------------------------------------

#: the loop's rates and its solver budget: a 100 Hz controller over a plant
#: integrated with RK4 in substeps of 2.5 ms; 150 ADMM iterations a tick,
#: convergence checked (and the penalty adapted) every 25
CONTROL_DT = 0.01
PHYSICS_DT = 0.0025
WBC_ITERATIONS = 150
WBC_CHECK_EVERY = 25


class StandingFleet(NamedTuple):
    """A fleet of 23-DoF humanoids in double support, and what each lane's
    balance controller holds on to."""

    tree: KinematicTree
    params: WholeBodyParams
    state: rb.FloatingBaseState    # every field (B, ...)
    com_ref: torch.Tensor          # (B, 3) each lane's own initial CoM
    q_ref: torch.Tensor            # (B, n) each lane's own initial posture


class WBCWarmStart(NamedTuple):
    """What the whole-body QP carries from tick to tick."""

    x: torch.Tensor                # (B, nx)
    y: torch.Tensor                # (B, m)
    s: torch.Tensor                # (B, 1)


def _standing_posture(tree: KinematicTree) -> np.ndarray:
    """Hip pitch 0.25, knee -0.5, ankle pitch 0.25 rad on both legs."""
    q_nom = np.zeros(tree.num_dofs)
    for side in ("l", "r"):
        for link, value in ((f"{side}_upper_leg", 0.25),     # hip pitch
                            (f"{side}_lower_leg", -0.5),     # knee
                            (f"{side}_ankle_1", 0.25)):      # ankle pitch
            q_nom[tree.dof_index[tree.link_names.index(link)]] = value
    return q_nom


def standing_fleet(batch: int, *, seed: int = 0, device=None,
                   dtype: Optional[torch.dtype] = None) -> StandingFleet:
    """``batch`` humanoids at rest in a slightly bent, statically stable
    double-support posture (hip pitch 0.25, knee -0.5, ankle pitch 0.25 rad;
    the base placed so that the soles of the nominal posture lie on z = 0),
    each lane's joints offset by its own draw, uniform in +-0.02 rad."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    tree = make_humanoid_23dof()
    n = tree.num_dofs
    q_nom = _standing_posture(tree)
    dq = np.random.default_rng(seed).uniform(-0.02, 0.02, (batch, n))
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    eye = torch.eye(3, dtype=dtype, device=device)
    poses = forward_kinematics(tree, as_t(np.zeros(3)), eye, as_t(q_nom))
    _, p_sole = frame_pose(tree, poses, "l_sole")
    base_position = torch.stack(
        [torch.zeros_like(p_sole[2]), torch.zeros_like(p_sole[2]), -p_sole[2]])
    state = rb.FloatingBaseState(
        base_twist=torch.zeros((batch, 6), dtype=dtype, device=device),
        joint_velocities=torch.zeros((batch, n), dtype=dtype, device=device),
        base_position=base_position.repeat(batch, 1),
        base_rotation=eye.repeat(batch, 1, 1),
        joint_positions=as_t(q_nom + dq),
    )
    poses = forward_kinematics(tree, state.base_position, state.base_rotation,
                               state.joint_positions)
    return StandingFleet(
        tree=tree, params=WholeBodyParams(contact_frames=HUMANOID_SOLE_FRAMES),
        state=state, com_ref=rb.com_position(tree, poses),
        q_ref=state.joint_positions.clone())


def balance_task(fleet: StandingFleet, state: rb.FloatingBaseState) -> WholeBodyTask:
    """The balance controller's targets for this tick: PD on each lane's own
    CoM reference (100 / 20) and posture reference (100 / 20), base angular
    damping (20), both soles in contact."""
    tree = fleet.tree
    poses = forward_kinematics(tree, state.base_position, state.base_rotation,
                               state.joint_positions)
    com = rb.com_position(tree, poses)
    com_vel = rb.com_velocity(
        tree, poses, torch.cat([state.base_twist, state.joint_velocities], dim=-1))
    q = state.joint_positions
    return WholeBodyTask(
        com_acc_des=100.0 * (fleet.com_ref - com) - 20.0 * com_vel,
        base_ang_acc_des=-20.0 * state.base_twist[..., 3:],
        posture_acc_des=100.0 * (fleet.q_ref - q) - 20.0 * state.joint_velocities,
        contact_active=torch.ones(q.shape[:-1] + (len(fleet.params.contact_frames),),
                                  dtype=q.dtype, device=q.device),
    )


def apply_solution(fleet: StandingFleet, state: rb.FloatingBaseState,
                   sol: WholeBodySolution) -> rb.FloatingBaseState:
    """Advance the plant by one control tick under the QP's own torques and
    contact wrenches: RK4 over ``CONTROL_DT`` in substeps of ``PHYSICS_DT``,
    with Baumgarte stabilisation of the base rotation."""
    tree = fleet.tree
    inp = rb.FloatingBaseInput(
        joint_torques=sol.torques,
        contact_wrenches={f: sol.wrenches[..., c, :]
                          for c, f in enumerate(fleet.params.contact_frames)})
    dynamics = lambda s, u, t: rb.floating_base_dynamics(tree, s, u, t, rho=1.0)
    return integrate(dynamics, state, dt=PHYSICS_DT,
                     num_steps=round(CONTROL_DT / PHYSICS_DT), u=inp, method="rk4")


@torch.no_grad()
def wbc_balance_step(
    fleet: StandingFleet,
    state: rb.FloatingBaseState,
    warm: Optional[WBCWarmStart] = None,
    *,
    backend: str = "torch",
    eps: Optional[float] = None,
):
    """One 100 Hz tick of the balance loop, control plus plant, for every lane.

    Control (:func:`balance_task`): the whole-body QP is solved by
    ``solve_qp(backend=...)`` with ``WBC_ITERATIONS`` in stages of
    ``WBC_CHECK_EVERY``, warm-started from ``warm`` (the previous tick's
    ``x``, ``y`` and penalty ``s``). ``eps`` (absolute and relative tolerance) defaults to 1e-5 in
    float64 and 1e-4 in float32. Plant (:func:`apply_solution`): the QP's own
    torques and contact wrenches drive the rigid-body engine.

    Returns ``(new_state, solution, warm)``: the advanced state, the
    :class:`WholeBodySolution` of this tick, and the warm start of the next.
    """
    if eps is None:
        eps = 1e-5 if torch.finfo(state.joint_positions.dtype).bits >= 64 else 1e-4
    x0, y0, s0 = warm if warm is not None else (None, None, None)
    sol = solve_wholebody_qp(
        fleet.tree, fleet.params, state, balance_task(fleet, state),
        iterations=WBC_ITERATIONS, x0=x0, y0=y0, s0=s0, check_every=WBC_CHECK_EVERY,
        eps_abs=eps, eps_rel=eps, backend=backend)
    new_state = apply_solution(fleet, state, sol)
    return new_state, sol, WBCWarmStart(sol.qp.x, sol.qp.y, sol.qp.rho_scale)


# ---------------------------------------------------------------------------
# The whole control stack: a push-recovery fleet of the humanoid
# ---------------------------------------------------------------------------

#: the production configuration of the stack (the JAX package's stack bench,
#: ``STACK_r05.json`` ``detail.config``): horizon 8, 10 inner ticks an outer
#: tick, 2 ROS2-W substeps with the lagged plant M^-1 and the stiff-path stage
#: operator, MPC 100 iterations, WBC 150 iterations in one stage without
#: polish and 4 Ruiz rounds, both solves on the kernels: the MPC in the
#: reference's ``"pallas"`` mode, the bf16 delta form on the tensor cores
#: (``"cuda_delta"``), the WBC on the per-lane kernels (``"cuda"``)
STACK_R05 = StackConfig(
    mpc_dt=0.1, horizon=8, wbc_per_mpc=10, physics_per_wbc=2,
    plant_method="rosenbrock", mpc_iterations=100, wbc_iterations=150,
    wbc_check_every=150, wbc_polish_iters=0, wbc_scaling_iters=4,
    mpc_backend="cuda_delta", wbc_backend="cuda", plant_lagged_minv=True,
    ros_op_stiff=True)

#: the stance box around the CoM's ground projection: +-0.09 m in x, +-0.11 in y
_STANCE_HALF = (0.09, 0.09, 0.11, 0.11)


class PushRecoveryStack(NamedTuple):
    """A fleet of standing humanoids, each pushed by its own unseen constant
    force, and what the stack needs to balance them."""

    tree: KinematicTree
    params: WholeBodyParams
    lipm: LIPMParams
    config: StackConfig
    null_poses: dict             # sole frame -> (R0 (3, 3), p0 (3,))
    q_ref: torch.Tensor          # (n,) the posture held
    com_height_ref: float
    state: StackState            # every field (B, ...)
    pushes: torch.Tensor         # (B, 2) the true pushes [N]
    refs: tuple                  # (dcm_ref (N+1, 2), zmp_ref (N, 2), poly_A, poly_b)
    stance: torch.Tensor         # (2,) the CoM's ground projection at rest


def push_recovery_stack(batch: int, *, seed: int = 0, device=None,
                        dtype: Optional[torch.dtype] = None) -> PushRecoveryStack:
    """The stack bench's workload: ``batch`` 23-DoF humanoids standing at rest
    in the posture of :func:`standing_fleet` (no per-lane offsets), the DCM
    and ZMP references on the stance point, the support box around it, each
    sole's null pose one ``ground_sag`` above it (the ground starts loaded
    with the standing weight), and per-lane pushes uniform in +-8 N on each
    horizontal axis drawn from ``seed``; in the ``STACK_R05`` configuration."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    config = STACK_R05
    tree = make_humanoid_23dof()
    n, horizon = tree.num_dofs, config.horizon
    q_nom = as_t(_standing_posture(tree))
    eye = torch.eye(3, dtype=dtype, device=device)
    poses = forward_kinematics(tree, torch.zeros(3, dtype=dtype, device=device), eye, q_nom)
    _, p_sole = frame_pose(tree, poses, "l_sole")
    plant = rb.FloatingBaseState(
        base_twist=torch.zeros(6, dtype=dtype, device=device),
        joint_velocities=torch.zeros(n, dtype=dtype, device=device),
        base_position=as_t([0.0, 0.0, -float(p_sole[2])]),
        base_rotation=eye, joint_positions=q_nom)
    poses = forward_kinematics(tree, plant.base_position, plant.base_rotation, q_nom)
    com = rb.com_position(tree, poses)
    lipm = LIPMParams(as_t(float(com[2])), as_t(9.81))
    stance = com[:2]
    refs = (stance.expand(horizon + 1, 2).clone(), stance.expand(horizon, 2).clone(),
            as_t(_BOX).repeat(horizon, 1, 1),
            (torch.stack([stance[0], -stance[0], stance[1], -stance[1]])
             + as_t(_STANCE_HALF)).expand(horizon, 4).clone())
    null_poses = {f: (eye, frame_pose(tree, poses, f)[1] + as_t([0.0, 0.0, config.ground_sag]))
                  for f in HUMANOID_SOLE_FRAMES}
    lanes = rb.FloatingBaseState(*(leaf.expand((batch,) + tuple(leaf.shape)).clone()
                                   for leaf in plant))
    return PushRecoveryStack(
        tree=tree, params=WholeBodyParams(contact_frames=HUMANOID_SOLE_FRAMES),
        lipm=lipm, config=config, null_poses=null_poses, q_ref=q_nom,
        com_height_ref=float(com[2]),
        state=init_stack(tree, lipm, config, lanes, 6 * horizon),
        pushes=as_t(np.random.default_rng(seed).uniform(-8.0, 8.0, (batch, 2))),
        refs=refs, stance=stance)


def stack_fleet_step(problem: PushRecoveryStack, config: Optional[StackConfig] = None):
    """:func:`blf_tpu_torch.mpc.stack.make_fleet_stack_step` for the problem,
    in its own configuration unless ``config`` is given; called as
    ``step(state, problem.pushes, *problem.refs)``."""
    return make_fleet_stack_step(
        problem.tree, problem.params, problem.lipm,
        problem.config if config is None else config, problem.null_poses,
        q_ref=problem.q_ref, com_height_ref=problem.com_height_ref)


# ---------------------------------------------------------------------------
# BASELINE config 2: the spring-damper foot rollout and contact identification
# ---------------------------------------------------------------------------

class FootDropFleet(NamedTuple):
    """Inputs of :func:`blf_tpu_torch.models.foot.foot_rollout` for a fleet."""

    cparams: contact.ContactParams
    fparams: FootParams
    state: FootState               # every field (B, ...)
    null_position: torch.Tensor    # (B, 3)
    null_rotation: torch.Tensor    # (B, 3, 3), one pose for all lanes (lane stride 0)
    dt: float


def _foot_params(mass, inertia, rho, as_t) -> FootParams:
    return FootParams(mass=as_t(mass), inertia=as_t(inertia), baumgarte_rho=as_t(rho))


def foot_drop_fleet(batch: int, *, seed: int = 0, device=None,
                    dtype: Optional[torch.dtype] = None) -> FootDropFleet:
    """The Monte-Carlo workload of ``benchmarks/rollout_bench.py``: a 0.2 m x
    0.1 m patch with k = 2e5, b = 2e3, a 0.75 kg foot with inertia
    (2e-3, 4e-3, 5e-3), rho = 10, dt = 1 ms, every lane's state drawn (in this
    order) as position N(0, 1e-3), rotation exp(N(0, 0.02)), linear and
    angular velocity N(0, 0.05); the null pose at the origin."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    state = FootState(
        position=as_t(rng.normal(0, 1e-3, (batch, 3))),
        rotation=so3_exp(as_t(rng.normal(0, 0.02, (batch, 3)))),
        linear_velocity=as_t(rng.normal(0, 0.05, (batch, 3))),
        angular_velocity=as_t(rng.normal(0, 0.05, (batch, 3))))
    return FootDropFleet(
        cparams=contact.ContactParams(as_t(0.2), as_t(0.1), as_t(2e5), as_t(2e3)),
        fparams=_foot_params(0.75, [2e-3, 4e-3, 5e-3], 10.0, as_t),
        state=state,
        null_position=torch.zeros((batch, 3), dtype=dtype, device=device),
        null_rotation=torch.eye(3, dtype=dtype, device=device).expand(batch, 3, 3),
        dt=1e-3)


class ContactIdentificationFleet(NamedTuple):
    """A fleet of feet dropped on patches of unknown (k, b), and what each
    lane's RLS estimator is configured with."""

    cparams: contact.ContactParams  # length, width scalar; k, b (B, 1), the truth
    fparams: FootParams
    state: FootState                # every field (B, ...)
    null_position: torch.Tensor     # (3,)
    null_rotation: torch.Tensor     # (3, 3)
    dt: float
    noise: torch.Tensor             # (T, B, 6) wrench measurement noise
    handler: ParametersHandler      # the estimator's configuration


def contact_identification_fleet(batch: int, *, samples: int = 200, seed: int = 0,
                                 device=None, dtype: Optional[torch.dtype] = None
                                 ) -> ContactIdentificationFleet:
    """The physics of ``examples/02_contact_identification.py`` over a fleet:
    a 0.12 m x 0.09 m patch, a 0.8 kg foot with inertia (2e-3, 3e-3, 4e-3),
    rho = 1, dt = 0.1 ms, dropped 5 mm below the null pose at the origin,
    moving. Per lane, drawn in this order: k uniform in [4000, 12000],
    b uniform in [200, 600], position (0, 0, -0.005) + N(0, 1e-3), rotation
    exp(N(0, 0.02)), linear velocity (0.05, -0.03, 0) + N(0, 0.02), angular
    velocity (0.1, 0.2, -0.1) + N(0, 0.05), and the wrench noise N(0, 0.05)
    of ``samples`` measurements; the RLS keys of the example."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    k = rng.uniform(4000.0, 12000.0, (batch, 1))
    b = rng.uniform(200.0, 600.0, (batch, 1))
    state = FootState(
        position=as_t(np.array([0.0, 0.0, -0.005]) + rng.normal(0, 1e-3, (batch, 3))),
        rotation=so3_exp(as_t(rng.normal(0, 0.02, (batch, 3)))),
        linear_velocity=as_t(np.array([0.05, -0.03, 0.0]) + rng.normal(0, 0.02, (batch, 3))),
        angular_velocity=as_t(np.array([0.1, 0.2, -0.1]) + rng.normal(0, 0.05, (batch, 3))))
    noise = as_t(rng.normal(0, 0.05, (samples, batch, 6)))
    return ContactIdentificationFleet(
        cparams=contact.ContactParams(as_t(0.12), as_t(0.09), as_t(k), as_t(b)),
        fparams=_foot_params(0.8, [2e-3, 3e-3, 4e-3], 1.0, as_t),
        state=state,
        null_position=torch.zeros(3, dtype=dtype, device=device),
        null_rotation=torch.eye(3, dtype=dtype, device=device),
        dt=1e-4, noise=noise,
        handler=ParametersHandler({
            "lambda": 1.0, "measurement_covariance": [0.05 ** 2] * 6,
            "state": [0.0, 0.0], "state_covariance": [1e6, 1e6]}))


class Identification(NamedTuple):
    """Each lane's (k, b): the three RLS forms' final estimates and the truth."""

    scan: torch.Tensor      # (B, 2) rls_scan, the reference's sequential filter
    fit: torch.Tensor       # (B, 2) rls_fit, one weighted reduction
    parallel: torch.Tensor  # (B, 2) rls_parallel, the log-depth scan
    true: torch.Tensor      # (B, 2)


#: Euler steps between two wrench samples of :func:`identify_contacts`: the
#: example's 1 kHz measurements of a 10 kHz simulation
IDENTIFY_STEPS_PER_SAMPLE = 10

#: the parts of :func:`identify_contacts`, each a span ``identify.<part>``
#: (:func:`blf_tpu_torch.utils.profiling.trace`)
IDENTIFY_PARTS = ("rollout", "wrench", "rls_scan", "rls_fit", "rls_parallel")


def identify_contacts(problem: ContactIdentificationFleet, *,
                      backend: str = "cuda") -> Identification:
    """Example 02 over the fleet: roll every foot out in T segments of
    ``IDENTIFY_STEPS_PER_SAMPLE`` Euler steps, T the fleet's samples of noise
    (``foot_rollout(backend=...)``, one kernel launch a segment on
    ``"cuda"``), record the state after each, take the contact regressor and
    the wrench plus the fleet's noise along the (T, B) record, and identify
    each lane's (k, b) with ``rls_scan``, ``rls_fit`` and ``rls_parallel``
    configured from the handler, one filter a lane."""
    cp, dtype, device = problem.cparams, problem.noise.dtype, problem.noise.device
    with trace("identify.rollout"):
        state, record = problem.state, []
        for _ in range(problem.noise.shape[0]):
            state = foot_rollout(cp, problem.fparams, state, problem.null_position,
                                 problem.null_rotation, problem.dt,
                                 IDENTIFY_STEPS_PER_SAMPLE, backend=backend)
            record.append(state)
        traj = FootState(*(torch.stack(field) for field in zip(*record)))   # (T, B, ...)
    with trace("identify.wrench"):
        shape = traj.position.shape
        cstates = contact.ContactState(
            *traj, null_position=problem.null_position.expand(shape),
            null_rotation=problem.null_rotation.expand(shape + (3,)))
        regressors = contact.regressor(cp, cstates)                         # (T, B, 6, 2)
        wrenches = contact.contact_wrench(cp, cstates) + problem.noise
    params, rls0 = init_from_handler(problem.handler, device=device, dtype=dtype)
    lanes = regressors.shape[1]
    rls0 = RLSState(rls0.theta.expand(lanes, -1), rls0.covariance.expand(lanes, -1, -1))
    with trace("identify.rls_scan"):
        scan = rls_scan(params, rls0, regressors, wrenches)
    with trace("identify.rls_fit"):
        fit = rls_fit(params, rls0, regressors, wrenches)
    with trace("identify.rls_parallel"):
        par, _ = rls_parallel(params, rls0, regressors, wrenches)
    return Identification(scan=scan.theta, fit=fit.theta, parallel=par.theta,
                          true=torch.cat([cp.spring_coeff, cp.damper_coeff], dim=-1))


# ---------------------------------------------------------------------------
# BASELINE config 3: a fleet of 10-step gaits
# ---------------------------------------------------------------------------

#: ADMM iterations of a gait plan of the fleet (4 stages of 25)
GAIT_ITERATIONS = 100


class GaitFleet(NamedTuple):
    """The arguments of ``plan_gait`` for a fleet of lanes on one gait."""

    params: LIPMParams
    lists: dict                # {"left": ContactList, "right": ContactList}
    dt: float
    dcm0: torch.Tensor         # (B, 2) initial DCM of each lane
    com0: torch.Tensor         # (B, 2) = dcm0


def gait_fleet(batch: int, *, num_steps: int = 10, step_length: float = 0.15,
               seed: int = 0, device=None, dtype: Optional[torch.dtype] = None
               ) -> GaitFleet:
    """Config 3 over a fleet: the gait of ``footstep_plan(num_steps,
    step_length)`` (10 steps of 0.15 m: 96 knots of dt = 0.1, a shared QP of
    (m, n) = (960, 384)) planned from ``batch`` initial DCMs drawn from
    U(-0.02, 0.02) m per axis, com0 = dcm0, as
    ``tests/test_gait.py::test_batched_gait_scenarios`` draws its sweep. Every
    lane shares the schedule, the polygons and the references, so
    ``plan_gait(*fleet, shared=True)`` solves them against one factorization."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    rng = np.random.default_rng(seed)
    dcm0 = torch.as_tensor(rng.uniform(-0.02, 0.02, (batch, 2)), dtype=dtype, device=device)
    return GaitFleet(params=_lipm(device, dtype),
                     lists=footstep_plan(num_steps=num_steps, step_length=step_length),
                     dt=0.1, dcm0=dcm0, com0=dcm0.clone())


# ---------------------------------------------------------------------------
# The time-varying DCM planner over a fleet of pushed initial DCMs
# ---------------------------------------------------------------------------

class DCMPlannerFleet(NamedTuple):
    """The positional arguments of ``plan_time_varying_dcm_batch`` for a
    fleet of lanes on one plan."""

    params: LIPMParams
    dt: float
    dcm0: torch.Tensor         # (B, 3) initial DCM of each lane
    omega0: torch.Tensor       # (B,) initial omega of each lane (nominal)
    zmp_ref: torch.Tensor      # (T, 2)
    poly_A: torch.Tensor       # (T, 4, 2)
    poly_b: torch.Tensor       # (T, 4)
    dcm_goal: torch.Tensor     # (3,)


def dcm_planner_fleet(batch: int, horizon: int, *, seed: int = 0, device=None,
                      dtype: Optional[torch.dtype] = None) -> DCMPlannerFleet:
    """``tests/test_sqp.py::_planner_problem(horizon, dt=0.1, z_nom=0.9,
    margin=0.08)``, the push-recovery variant, for ``batch`` lanes: four
    footholds repeated ``horizon // 4`` knots each (so 28 knots for a
    horizon of 30), square support polygons of half-width 0.08 m around each
    reference point, and the goal at the end of the DCM backward recursion
    (z = 0.9). Each lane starts at the recursion's first DCM plus a push
    drawn from U(-0.05, 0.05) per axis (inside the test's own push of
    (+0.06, -0.05)), at z = 0.9 and the nominal omega."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    dt, z_nom, margin = 0.1, 0.9, 0.08
    steps = np.array([[0.0, 0.0], [0.15, 0.1], [0.3, -0.1], [0.45, 0.0]])
    zmp_ref = np.repeat(steps, horizon // len(steps), axis=0)
    exact = LIPMParams(torch.tensor(z_nom, dtype=torch.float64),
                       torch.tensor(9.81, dtype=torch.float64))
    zmp64 = torch.as_tensor(zmp_ref)
    xy_ref = dcm_backward_recursion(exact, zmp64, zmp64[-1], dt).numpy()
    poly_b = np.stack([zmp_ref[:, 0] + margin, -(zmp_ref[:, 0] - margin),
                       zmp_ref[:, 1] + margin, -(zmp_ref[:, 1] - margin)], -1)
    rng = np.random.default_rng(seed)
    push = rng.uniform(-0.05, 0.05, (batch, 2))
    dcm0 = np.concatenate([xy_ref[0] + push, np.full((batch, 1), z_nom)], -1)
    params = _lipm(device, dtype)
    return DCMPlannerFleet(
        params=params, dt=dt, dcm0=as_t(dcm0),
        omega0=torch.sqrt(params.gravity / params.com_height).expand(batch).clone(),
        zmp_ref=as_t(zmp_ref), poly_A=as_t(_BOX).repeat(zmp_ref.shape[0], 1, 1),
        poly_b=as_t(poly_b), dcm_goal=as_t(np.append(xy_ref[-1], z_nom)))


def random_lqr_batch(batch: int, horizon: int, *, nx: int = 4, nu: int = 2, seed: int = 0,
                     device=None, dtype: Optional[torch.dtype] = None):
    """``(Fs, cs, Ls, Qs, Rs, QT, x0)`` of ``batch`` random stable LQ problems
    with the distributions of ``tests/test_riccati.py::random_lqr``: F = I +
    N(0, 0.05^2), c ~ N(0, 0.1^2), L ~ N(0, 0.3^2), Q = q I with q ~ U(0.5,
    2) and R = r I with r ~ U(0.1, 1) at each knot, Q_T = 5 I, x0 ~ N(0, 1);
    the arguments of ``solve_lqr`` with a leading batch axis."""
    device = resolve_device(device)
    dtype = resolve_dtype(dtype)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    shape = (batch, horizon)
    Fs = np.eye(nx) + 0.05 * rng.normal(size=shape + (nx, nx))
    cs = 0.1 * rng.normal(size=shape + (nx,))
    Ls = 0.3 * rng.normal(size=shape + (nx, nu))
    Qs = rng.uniform(0.5, 2.0, shape)[..., None, None] * np.eye(nx)
    Rs = rng.uniform(0.1, 1.0, shape)[..., None, None] * np.eye(nu)
    QT = np.tile(5.0 * np.eye(nx), (batch, 1, 1))
    x0 = rng.normal(size=(batch, nx))
    return tuple(as_t(a) for a in (Fs, cs, Ls, Qs, Rs, QT, x0))
