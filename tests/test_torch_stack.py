"""Slice 2b as a whole: the control stack's fleet tick against ``blf_tpu``.

``make_fleet_stack_step`` on four lanes of the 6-DoF biped of
``tests/test_torch_wbc_loop.py`` (with a push frame on the pelvis; WBC QP of
m = 52 rows and n = 30 unknowns, plant state D = 30, M 12 x 12), float64, in
the production configuration: ROS2-W in 2 substeps with the lagged plant
M^-1 and the stiff-path stage operator, MPC 100 iterations, WBC 150 in one
stage, 4 Ruiz rounds, no polish, ``wbc_eps = 1e-4`` (as
``tests/test_control_stack.py`` sets it for the kernel path). The port runs
``"cuda"`` on both solves, which on CPU tensors are the kernels' plain
versions; the reference runs ``mpc_backend="pallas_f32"`` and
``wbc_backend="pallas"``, its Pallas kernels in interpret mode. Two things on
the reference side are worth knowing:

* its MPC takes the kernel only for a batch that is a multiple of 256
  (``blf_tpu/mpc/qp.py:846-850``); four lanes run the same v-space recursion
  on XLA with refinement dropped, which is what the port's plain version of
  K1 computes;
* its lagged M^-1 (K3, n = 12) and its attribution solve (K4, n = 6) run
  through Pallas whatever the backends say, and so do the port's.

Two outer ticks of ten inner ticks from the same seeded state and pushes:
plant state, push estimate and DCM trace within 1e-6 (each inner tick's QP
solved to 1e-4 on both sides from iterates that agree to ~1e-10, and the
plant integrates 10 ms of the difference), statuses and converged flags
identical. Then a poisoned lane goes NUMERICAL_ERROR and is reset on both
sides, and the per-lane ``make_stack_step`` matches the fleet step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blf_tpu.models import kinematics as jkin
from blf_tpu.models import rigid_body as jrb
from blf_tpu.estimators.wrench_observer import MomentumObserverState as JObserverState
from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.mpc import stack as jstack
from blf_tpu.mpc.wholebody import WholeBodyParams as JWholeBodyParams
from blf_tpu_torch.convert import stack_state_from_numpy, stack_state_to_numpy
from blf_tpu_torch.models import kinematics as tkin
from blf_tpu_torch.models import rigid_body as trb
from blf_tpu_torch.models.lipm import LIPMParams
from blf_tpu_torch.mpc import stack as tstack
from blf_tpu_torch.mpc.wholebody import WholeBodyParams
from blf_tpu_torch.ops.cuda import admm, admm_lane, linalg
from blf_tpu_torch.utils.status import SolverStatus
from test_torch_wbc_loop import SOLES, in_background, make_biped, reference_jit

# One intra-op thread: the tensors here are a few lanes wide, so more threads
# gain nothing, and test workers running side by side would each start a
# thread per core and slow every other worker down.
torch.set_num_threads(1)

B, HORIZON, TICKS, TOL = 4, 8, 2, 1e-6
PUSHES = np.random.default_rng(0).uniform(-8.0, 8.0, (B, 2))
CONFIG = dict(mpc_dt=0.1, horizon=HORIZON, wbc_per_mpc=10, physics_per_wbc=2,
              plant_method="rosenbrock", mpc_iterations=100, wbc_iterations=150,
              wbc_check_every=150, wbc_polish_iters=0, wbc_scaling_iters=4,
              plant_lagged_minv=True, ros_op_stiff=True, wbc_eps=1e-4)


@functools.lru_cache(maxsize=None)
def setting():
    """Numpy arrays both sides are built from: the standing posture, the
    references and the ground anchors one ``ground_sag`` above each sole."""
    tree = make_biped(tkin.KinematicTreeBuilder, push_frame=True)
    f64 = dict(dtype=torch.float64)
    q = torch.tensor([0.25, -0.5, 0.25, 0.25, -0.5, 0.25], **f64)
    poses = tkin.forward_kinematics(tree, torch.zeros(3, **f64), torch.eye(3, **f64), q)
    base = torch.tensor([0.0, 0.0, -float(tkin.frame_pose(tree, poses, "l_sole")[1][2])], **f64)
    poses = tkin.forward_kinematics(tree, base, torch.eye(3, **f64), q)
    com = trb.com_position(tree, poses).numpy()
    stance = com[:2]
    box = np.array([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]])
    half = np.array([0.09, 0.09, 0.11, 0.11])
    refs = (np.broadcast_to(stance, (HORIZON + 1, 2)), np.broadcast_to(stance, (HORIZON, 2)),
            np.tile(box, (HORIZON, 1, 1)),
            np.broadcast_to(np.array([stance[0], -stance[0], stance[1], -stance[1]]) + half,
                            (HORIZON, 4)))
    anchors = {f: tkin.frame_pose(tree, poses, f)[1].numpy() + [0.0, 0.0, 2e-3] for f in SOLES}
    return dict(q=q.numpy(), base=base.numpy(), com=com, refs=refs, anchors=anchors)


@functools.lru_cache(maxsize=None)
def reference():
    """``(step, state0, refs)`` of ``blf_tpu``: the jitted fleet tick on the
    kernel backends and four lanes at rest; compiled once for the module."""
    s = setting()
    tree = make_biped(jkin.KinematicTreeBuilder, push_frame=True)
    config = jstack.StackConfig(**CONFIG, mpc_backend="pallas_f32", wbc_backend="pallas")
    lipm = JLIPMParams(jnp.asarray(s["com"][2]), jnp.asarray(9.81))
    null_poses = {f: (jnp.eye(3), jnp.asarray(p)) for f, p in s["anchors"].items()}
    step = reference_jit(jstack.make_fleet_stack_step(
        tree, JWholeBodyParams(contact_frames=SOLES), lipm, config, null_poses,
        q_ref=jnp.asarray(s["q"]), com_height_ref=float(s["com"][2])))
    n = tree.num_dofs
    plant = jrb.FloatingBaseState(jnp.zeros(6), jnp.zeros(n), jnp.asarray(s["base"]),
                                  jnp.eye(3), jnp.asarray(s["q"]))
    state0 = jstack.init_stack(tree, lipm, config, plant, 6 * HORIZON)
    state0 = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), state0)
    return step, state0, tuple(jnp.asarray(r) for r in s["refs"])


def port(per_lane=False, **overrides):
    """``(step, refs)`` of the port on the CPU in float64."""
    s = setting()
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    config = tstack.StackConfig(**{**CONFIG, "mpc_backend": "cuda", "wbc_backend": "cuda",
                                   **overrides})
    make = tstack.make_stack_step if per_lane else tstack.make_fleet_stack_step
    step = make(make_biped(tkin.KinematicTreeBuilder, push_frame=True),
                WholeBodyParams(contact_frames=SOLES),
                LIPMParams(as_t(s["com"][2]), as_t(9.81)), config,
                {f: (torch.eye(3, dtype=torch.float64), as_t(p)) for f, p in s["anchors"].items()},
                q_ref=as_t(s["q"]), com_height_ref=float(s["com"][2]))
    return step, tuple(as_t(r) for r in s["refs"])


def to_port(jax_state):
    return stack_state_from_numpy(jax.tree_util.tree_map(np.asarray, jax_state),
                                  device="cpu", dtype=torch.float64)


def assert_same_tick(state, trace, ref_state, ref_trace, what):
    ours, theirs = stack_state_to_numpy(state), to_numpy_tree(ref_state)
    for name, val in ours["plant"].items():
        np.testing.assert_allclose(val, theirs["plant"][name], atol=TOL, rtol=0,
                                   err_msg=f"{what}: plant.{name}")
    np.testing.assert_allclose(ours["push_theta"], theirs["push_theta"], atol=TOL, rtol=0,
                               err_msg=f"{what}: push estimate")
    np.testing.assert_allclose(trace.dcm.numpy(), np.asarray(ref_trace.dcm), atol=TOL,
                               rtol=0, err_msg=f"{what}: DCM trace")
    np.testing.assert_allclose(trace.push_estimate.numpy(), np.asarray(ref_trace.push_estimate),
                               atol=TOL, rtol=0, err_msg=f"{what}: estimate fed to the WBC")
    for name in ("status", "mpc_converged", "wbc_converged"):
        np.testing.assert_array_equal(getattr(trace, name).numpy(),
                                      np.asarray(getattr(ref_trace, name)),
                                      err_msg=f"{what}: {name}")


def to_numpy_tree(jax_state):
    state = jax.tree_util.tree_map(np.asarray, jax_state)
    return {"plant": state.plant._asdict(), "push_theta": state.push_theta}


def test_two_outer_ticks_match_the_reference_and_a_poisoned_lane_is_reset():
    ref_step, ref_state, ref_refs = reference()
    # the reference's tick is traced here and compiled on a thread while the
    # port runs its ticks; then the reference runs its own
    ref_step = in_background(ref_step.lower(ref_state, jnp.asarray(PUSHES), *ref_refs).compile)
    step, refs = port()
    pushes = torch.as_tensor(PUSHES)
    state = to_port(ref_state)
    for counts in (admm, admm_lane, linalg):
        counts.reset_counts()
    ours = []
    for _ in range(TICKS):
        state, trace = step(state, pushes, *refs)
        ours.append((state, trace))
    ref_step = ref_step()
    for k, (ours_state, ours_trace) in enumerate(ours):
        ref_state, ref_trace = ref_step(ref_state, jnp.asarray(PUSHES), *ref_refs)
        assert_same_tick(ours_state, ours_trace, ref_state, ref_trace, f"tick {k + 1}")
    # every kernel of the path ran its plain version on the CPU, as often as
    # the configuration says: K1 4 stages of 25 a tick, K2 one stage an inner
    # tick, K3 the lagged M^-1 once a tick and the KKT once an inner tick, K4
    # once an inner tick
    assert admm.reference_count() == 4 * TICKS
    assert admm_lane.reference_count() == 10 * TICKS
    assert linalg.reference_count() == 11 * TICKS
    assert linalg.solve_reference_count() == 10 * TICKS
    assert admm.launch_count() == admm_lane.launch_count() == linalg.launch_count() \
        == linalg.solve_launch_count() == 0
    assert (trace.status == int(SolverStatus.CONVERGED)).any()
    assert float(state.plant.base_rotation[:, 2, 2].min()) > 0.99

    # a lane poisoned mid-episode goes NUMERICAL_ERROR and restarts from its
    # pre-tick state, NaNs sanitized and warm starts cleared, on both sides
    ref_poisoned = ref_state._replace(plant=ref_state.plant._replace(
        base_twist=ref_state.plant.base_twist.at[1, 0].set(jnp.nan)))
    poisoned = to_port(ref_poisoned)
    ref_after, ref_trace = ref_step(ref_poisoned, jnp.asarray(PUSHES), *ref_refs)
    after, trace = step(poisoned, pushes, *refs)
    assert int(trace.status[1]) == int(SolverStatus.NUMERICAL_ERROR)
    np.testing.assert_array_equal(trace.status.numpy(), np.asarray(ref_trace.status))
    assert all(bool(torch.isfinite(t).all()) for t in jax.tree_util.tree_leaves(
        stack_state_to_numpy(after)) if isinstance(t, torch.Tensor))
    flat = stack_state_to_numpy(after)
    assert np.isfinite(flat["plant"]["base_twist"]).all()
    assert float(np.abs(flat["warm_wbc_x"][1]).max()) == 0.0
    assert float(np.abs(flat["push_theta"][1]).max()) == 0.0
    np.testing.assert_array_equal(flat["plant"]["base_twist"][1],
                                  np.nan_to_num(np.asarray(ref_poisoned.plant.base_twist[1]), nan=0.0))
    healthy = [0, 2, 3]
    theirs = to_numpy_tree(ref_after)
    for name, val in flat["plant"].items():
        np.testing.assert_allclose(val[healthy], theirs["plant"][name][healthy], atol=TOL,
                                   rtol=0, err_msg=f"healthy lanes: plant.{name}")


def test_per_lane_step_matches_the_fleet_step():
    """``make_stack_step`` (the reference's vmapped tick) against the fleet
    step on the same lanes, one outer tick, both on the plain-tensor solvers
    with the full-dynamics stage operator: they differ only in how the
    attribution is solved (dense against K4's plain version), and agree to
    the reference's own 1e-5."""
    _, ref_state, _ = reference()
    plain = dict(mpc_backend="torch", wbc_backend="torch", plant_lagged_minv=False,
                 ros_op_stiff=False, wbc_iterations=50, wbc_check_every=25)
    fleet_step, refs = port(**plain)
    lane_step, _ = port(per_lane=True, **plain)
    state, pushes = to_port(ref_state), torch.as_tensor(PUSHES)
    linalg.reset_counts()
    a, ta = fleet_step(state, pushes, *refs)
    assert linalg.solve_reference_count() == 10
    b, tb = lane_step(state, pushes, *refs)
    assert linalg.solve_reference_count() == 10
    for name, val in stack_state_to_numpy(a)["plant"].items():
        np.testing.assert_allclose(val, stack_state_to_numpy(b)["plant"][name], atol=1e-5,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(a.push_theta.numpy(), b.push_theta.numpy(), atol=1e-5)
    np.testing.assert_allclose(ta.dcm.numpy(), tb.dcm.numpy(), atol=1e-6)
    np.testing.assert_array_equal(ta.wbc_converged.numpy(), tb.wbc_converged.numpy())
    assert tuple(ta.status.shape) == (B,)


# ---------------------------------------------------------------------------
# The study: the humanoid's stack in float32, both packages, convergence by tick
# ---------------------------------------------------------------------------

def jax_stack_state(state):
    """The port's :class:`StackState` as the JAX package's, float32."""
    tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  stack_state_to_numpy(state))
    return jstack.StackState(**{**tree, "plant": jrb.FloatingBaseState(**tree["plant"]),
                                "observer": JObserverState(**tree["observer"])})


def tick_row(trace, state, pushes, stance):
    f = lambda v: float(f"{float(v):.3g}")
    status = np.asarray(trace.status)
    rp, rd = np.asarray(trace.wbc_max_rp), np.asarray(trace.wbc_max_rd)
    return [int((status == 0).sum()), int(np.asarray(trace.mpc_converged).sum()),
            int(np.asarray(trace.wbc_converged).sum()), int((status == 2).sum()),
            f(np.median(rp)), f(rp.max()), f(np.median(rd)), f(rd.max()),
            f(np.abs(np.asarray(trace.dcm) - stance).max()),
            f(np.abs(np.asarray(state.push_theta) - pushes).max())]


#: the port's backends and the reference's names for them
REFERENCE_BACKEND = {"cuda_delta": "pallas", "cuda_split": "pallas_split", "cuda": "pallas_f32",
                     "torch": "xla"}


def mpc_pairs(problem, warm):
    """One outer tick from the same warm state with the MPC on other backends
    (the plain versions, on the CPU): ``"cuda_delta"`` in its own float32
    order and in the tensor-core kernel's (pass after pass, 16 contraction
    terms at a time), and ``"cuda"``; plan, duals and converged flags."""
    from unittest import mock

    from blf_tpu_torch.problems import stack_fleet_step
    from test_torch_admm_stage_tc import _kernel_order_dot2, _kernel_order_dot3

    def tick(backend, kernel_order=False):
        step = stack_fleet_step(problem, problem.config._replace(mpc_backend=backend))
        with mock.patch.object(admm, "_lsplit_dot3",
                               _kernel_order_dot3 if kernel_order else admm._lsplit_dot3), \
                mock.patch.object(admm, "_lsplit_dot2",
                                  _kernel_order_dot2 if kernel_order else admm._lsplit_dot2):
            st, tr = step(warm, problem.pushes, *problem.refs)
        return st.warm_zmp, st.warm_y, tr.mpc_converged

    delta, delta_k, exact = tick("cuda_delta"), tick("cuda_delta", True), tick("cuda")
    f = lambda v: float(f"{float(v):.3g}")
    both = delta[2] & exact[2]
    plan = (delta[0] - exact[0]).abs().amax(dim=(-2, -1))
    return {
        "delta_kernel_order": {
            "plan": f((delta_k[0] - delta[0]).abs().max()),
            "duals": f((delta_k[1] - delta[1]).abs().max()),
            "mpc_status_mismatches": int((delta_k[2] != delta[2]).sum())},
        "delta_against_cuda": {
            "mpc_converged": [int(delta[2].sum()), int(exact[2].sum())],
            "both_converged": int(both.sum()),
            "plan_both_converged": f(plan[both].max()) if bool(both.any()) else 0.0,
            "plan": f(plan.max())}}


def reference_mpc_converged(args, kw):
    """Lanes the reference's MPC converges, run eagerly on the port's own MPC
    inputs of a tick in the mode of the same name. Eagerly: under ``jax.jit``
    on the CPU its ``"pallas"`` (delta) MPC leaves the dual residual near 4e-5
    and converges no lane of the cold tick, where the same solve run eagerly
    converges every lane, as the port does."""
    from blf_tpu.models.lipm import LIPMParams as JLIPM
    from blf_tpu.mpc.dcm import solve_dcm_mpc

    f32 = lambda t: jnp.asarray(np.asarray(t), jnp.float32)
    lipm, dt, *rest = args
    jkw = {k: (f32(v) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
    jkw["backend"] = REFERENCE_BACKEND[kw["backend"]]
    plan = solve_dcm_mpc(JLIPM(f32(lipm.com_height), f32(lipm.gravity)), dt,
                         *[f32(x) for x in rest], **jkw)
    return int(np.asarray(plan.qp.converged).sum())


def main():
    """``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_stack.py [lanes]
    [ticks]``: ``push_recovery_stack`` (256 lanes, a multiple of 256 so that
    the reference's MPC takes its kernel, and 10 outer ticks unless told
    otherwise) in float32 in the ``STACK_R05`` configuration, in the port (the
    kernels' plain versions) and in ``blf_tpu`` (the same modes by the
    reference's names, its kernels in interpret mode), from the same state and
    pushes; the reference's MPC also eagerly on the port's MPC inputs of each
    tick (:func:`reference_mpc_converged`); then, from the port's state after
    the first tick, the MPC's backends one outer tick apart
    (:func:`mpc_pairs`). One JSON line with a row a tick on each side."""
    import json
    import sys
    import time

    from blf_tpu.models.lipm import LIPMParams as JLIPM
    from blf_tpu.models.robots import HUMANOID_SOLE_FRAMES, make_humanoid_23dof
    from unittest import mock

    from blf_tpu_torch.problems import push_recovery_stack, stack_fleet_step
    import test_torch_admm_stage_tc  # noqa: F401 (its imports turn float64 on: first)

    jax.config.update("jax_enable_x64", False)
    lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    torch.set_num_threads(4)
    problem = push_recovery_stack(lanes, seed=0, device="cpu", dtype=torch.float32)
    pushes, stance = problem.pushes.numpy(), problem.stance.numpy()
    t0 = time.perf_counter()
    step, state, port_rows, eager = stack_fleet_step(problem), problem.state, [], []
    mpc_calls, solve = [], tstack.solve_dcm_mpc

    def recorded(*args, **kw):
        mpc_calls.append((args, kw))
        return solve(*args, **kw)

    for k in range(ticks):
        with mock.patch.object(tstack, "solve_dcm_mpc", recorded):
            state, trace = step(state, problem.pushes, *problem.refs)
        port_rows.append(tick_row(trace, state, pushes, stance))
        eager.append(reference_mpc_converged(*mpc_calls.pop()))
        if k == 0:
            pairs = mpc_pairs(problem, state)
    t1 = time.perf_counter()
    print(json.dumps({"blf_tpu_torch_plain_versions": port_rows, "mpc_pairs_after_tick_1": pairs,
                      "blf_tpu_mpc_converged_eager_on_the_ports_inputs": eager}),
          file=sys.stderr, flush=True)

    c = problem.config._asdict()
    backends = {"mpc_backend": REFERENCE_BACKEND[c["mpc_backend"]],
                "wbc_backend": "pallas" if c["wbc_backend"] == "cuda" else "xla"}
    config = jstack.StackConfig(**{**c, **backends})
    f32 = lambda t: jnp.asarray(np.asarray(t), jnp.float32)
    jstep = jax.jit(jstack.make_fleet_stack_step(
        make_humanoid_23dof(), JWholeBodyParams(contact_frames=HUMANOID_SOLE_FRAMES),
        JLIPM(f32(problem.lipm.com_height), f32(problem.lipm.gravity)), config,
        {f: (f32(R), f32(p)) for f, (R, p) in problem.null_poses.items()},
        q_ref=f32(problem.q_ref), com_height_ref=problem.com_height_ref))
    jstate, refs, ref_rows = jax_stack_state(problem.state), [f32(r) for r in problem.refs], []
    for _ in range(ticks):
        jstate, jtrace = jstep(jstate, f32(pushes), *refs)
        ref_rows.append(tick_row(jtrace, jstate, pushes, stance))
    print(json.dumps({
        "lanes": lanes, "ticks": ticks, "dtype": "float32", "device": "cpu",
        "config": "STACK_R05", "backends": {"port": {k: c[k] for k in backends},
                                            "blf_tpu": backends},
        "columns": ["converged", "mpc_converged", "wbc_converged", "numerical_error",
                    "median_wbc_max_rp", "max_wbc_max_rp", "median_wbc_max_rd",
                    "max_wbc_max_rd", "max_dcm_err_m", "max_estimate_err_n"],
        "blf_tpu_pallas_interpret": ref_rows, "blf_tpu_torch_plain_versions": port_rows,
        "blf_tpu_mpc_converged_eager_on_the_ports_inputs": eager,
        "mpc_pairs_after_tick_1": pairs,
        "seconds": [round(t1 - t0, 1), round(time.perf_counter() - t1, 1)]}))


if __name__ == "__main__":
    main()
