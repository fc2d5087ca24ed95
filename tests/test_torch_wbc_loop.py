"""Slice 2a as a whole on the kernel backend, against ``blf_tpu``.

100 Hz ticks of ``wbc_balance_step(backend="cuda")`` on a small fleet: QP
build, warm-started ``solve_qp_lanes`` (on the CPU the two kernels' plain
versions, six of each a tick), RK4 plant, against the same loop written with
``blf_tpu``, from the same seeded inputs.

* Float64, five ticks, against the reference's ``backend="xla"`` (in float64
  its two solver paths agree to rounding; the two kernels' plain versions are
  held to the reference's Pallas kernels in interpret mode by
  ``tests/test_torch_admm_lane.py`` and ``tests/test_torch_chol_lane.py``):
  state and torques within 1e-6, a tick's QP being solved to eps = 1e-5 on
  both sides from iterates that agree to ~1e-9, and the plant integrating 10
  ms of the difference.
* Float32, twenty ticks at eps = 1e-4, against the reference's
  ``backend="pallas"`` (its two Pallas kernels in interpret mode, the
  rounding the port's plain versions repeat): the converged flags and the penalty
  multiplier ``rho_scale`` tick by tick. Lane by lane the multiplier is not
  comparable early on: the rule that moves it takes the ratio of the relative
  primal to the relative dual residual, and in float32 the dual residual
  (~1e-6) is rounding, so on the first ticks the two sides' steps differ by up
  to x50 (measured; in float64 they agree to 1e-9). What both sides share,
  and what is held, is where it goes: it only ever sinks, a warm ``s0`` being
  taken unclipped, and settles in the same band. This robot keeps every lane
  inside eps while it does; the humanoid loses lanes after some 16 ticks, on
  both sides, which only the study below shows.

The robot of the tests is a 6-DoF two-leg biped built here with
``KinematicTreeBuilder`` on both sides (hip, knee and ankle pitch a leg; QP of
n = 30 unknowns and m = 52 rows): in interpret mode the reference's kernels
unroll m + 2 n steps an iteration, which at the humanoid's (86, 64) takes
minutes to compile. The 23-DoF humanoid runs the same loop on the other
backend in ``tests/test_torch_wholebody_loop.py``, and here as a study, not a
test:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_wbc_loop.py [lanes] [ticks]

runs the float32 loop on ``standing_fleet`` (64 lanes, 30 ticks unless told
otherwise; a few minutes) in both packages and prints, tick by tick, the lanes
converged, the median and max primal and dual residuals and the range of
``rho_scale`` on each side as one JSON line.
"""

import concurrent.futures
import contextlib
import functools
import importlib
import json
import sys
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blf_tpu.models import kinematics as jkin
from blf_tpu.models import rigid_body as jrb
from blf_tpu.models.robots import make_humanoid_23dof as jax_humanoid
from blf_tpu.mpc import wholebody as jwb
from blf_tpu.mpc.qp import solve_qp as jax_solve_qp
from blf_tpu.ops.integrators import integrate as jax_integrate
from blf_tpu_torch.convert import floating_base_state_to_numpy
from blf_tpu_torch.models import kinematics as tkin
from blf_tpu_torch.models import rigid_body as trb
from blf_tpu_torch.mpc.wholebody import WholeBodyParams
from blf_tpu_torch.ops.cuda import admm_lane, linalg
from blf_tpu_torch.problems import WBC_CHECK_EVERY as CHECK
from blf_tpu_torch.problems import WBC_ITERATIONS as ITERS
from blf_tpu_torch.problems import StandingFleet, standing_fleet, wbc_balance_step

# One intra-op thread: the tensors here are a few lanes wide, so more threads
# gain nothing, and test workers running side by side would each start a
# thread per core and slow every other worker down.
torch.set_num_threads(1)

SOLES = ("l_sole", "r_sole")

#: XLA's least optimization for the JAX references the port's tests compile:
#: at a few lanes they run in milliseconds either way, and the compile is what
#: a test waits for (about a third less of it). Not for the float32 test of
#: this file: it moves the reference's rounding (``rho_scale`` by decades),
#: and that test holds the reference's own rounding-driven behaviour.
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


#: the modules of ``blf_tpu`` that call its forward kinematics by name
_FK_CALLERS = ("blf_tpu.models.kinematics", "blf_tpu.models.rigid_body",
               "blf_tpu.mpc.wholebody", "blf_tpu.mpc.stack",
               "blf_tpu.estimators.wrench_observer")


def _jit_per_tree(fn):
    """``fn(tree, *args, **kwargs)`` as a ``jax.jit`` of itself for each tree
    and each set of static arguments: the arrays among the arguments are
    traced, everything else is static."""
    jitted = {}

    def once(tree, *args, **kwargs):
        leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
        traced = tuple(isinstance(leaf, (jax.Array, np.ndarray)) for leaf in leaves)
        static = tuple(leaf for leaf, t in zip(leaves, traced) if not t)
        key = (id(tree), treedef, traced, static)
        if key not in jitted:
            def call(arrays):
                it, st = iter(arrays), iter(static)
                a, kw = jax.tree_util.tree_unflatten(
                    treedef, [next(it) if t else next(st) for t in traced])
                return fn(tree, *a, **kw)

            jitted[key] = (tree, jax.jit(call))
        return jitted[key][1]([leaf for leaf, t in zip(leaves, traced) if t])

    return once


@contextlib.contextmanager
def traced_once_per_tree():
    """While a reference program is traced, the reference's forward
    kinematics and its floating-base dynamics are each a ``jax.jit`` of
    themselves for each tree: the mass matrix, the bias forces, every frame
    and the plant rerun the kinematics on the same shapes, and the plant's
    RK4 stages the dynamics; their traces are most of the program's. XLA
    inlines the inner programs, so the operations and their order do not
    change (the float32 loop of this file gives the same bits)."""
    with contextlib.ExitStack() as stack:
        fk = _jit_per_tree(jkin.forward_kinematics)
        for name in _FK_CALLERS:
            stack.enter_context(mock.patch.object(importlib.import_module(name),
                                                  "forward_kinematics", fk))
        stack.enter_context(mock.patch.object(
            jrb, "floating_base_dynamics", _jit_per_tree(jrb.floating_base_dynamics)))
        yield


def reference_jit(fn, compiler_options=FAST_COMPILE):
    """``jax.jit`` of a JAX reference with ``compiler_options``, traced with
    :func:`traced_once_per_tree`."""

    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with traced_once_per_tree():
            return fn(*args, **kwargs)

    return jax.jit(traced, compiler_options=compiler_options)


def run_reference(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of ``blf_tpu`` as one program compiled with
    :data:`FAST_COMPILE`: the arrays among the arguments (at any depth) are
    traced, everything else (sizes, options, time steps) is static. Called
    eagerly, a reference compiles each of its operations and inner jits at
    XLA's default optimization, which costs several times more."""
    leaves, treedef = jax.tree_util.tree_flatten((args, kwargs))
    traced = [isinstance(leaf, (jax.Array, np.ndarray)) for leaf in leaves]

    def call(arrays):
        it = iter(arrays)
        a, kw = jax.tree_util.tree_unflatten(
            treedef, [next(it) if t else leaf for leaf, t in zip(leaves, traced)])
        return fn(*a, **kw)

    return reference_jit(call)([leaf for leaf, t in zip(leaves, traced) if t])


def in_background(fn, *args, **kwargs):
    """Start ``fn(*args, **kwargs)`` (a JAX reference) on a thread of its own
    and return a function that waits for its result. XLA compiles outside
    Python's lock, so the caller's port run overlaps the reference's compile;
    what either computes does not change."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(fn, *args, **kwargs)
    pool.shutdown(wait=False)
    return future.result


def box_inertia(mass, lx, ly, lz):
    return mass / 12.0 * np.diag([ly * ly + lz * lz, lx * lx + lz * lz, lx * lx + ly * ly])


def make_biped(builder_cls, push_frame=False):
    """Pelvis and two legs of three pitch joints each, a sole frame a foot;
    with ``push_frame`` also a frame "imu" on the pelvis, where the control
    stack's push acts (``tests/test_torch_stack.py``)."""
    b = builder_cls(base_name="pelvis", base_mass=12.0, base_com=(0.0, 0.0, 0.1),
                    base_inertia=box_inertia(12.0, 0.2, 0.3, 0.4))
    for side, sgn in (("l", 1.0), ("r", -1.0)):
        b.add_link(f"{side}_thigh", "pelvis", axis=(0, 1, 0),
                   joint_position=(0.0, sgn * 0.08, -0.05), mass=2.5, com=(0, 0, -0.13),
                   inertia=box_inertia(2.5, 0.09, 0.09, 0.26))
        b.add_link(f"{side}_shank", f"{side}_thigh", axis=(0, 1, 0),
                   joint_position=(0, 0, -0.26), mass=1.8, com=(0, 0, -0.12),
                   inertia=box_inertia(1.8, 0.07, 0.07, 0.24))
        b.add_link(f"{side}_foot", f"{side}_shank", axis=(0, 1, 0),
                   joint_position=(0, 0, -0.24), mass=0.6, com=(0.03, 0, -0.03),
                   inertia=box_inertia(0.6, 0.14, 0.07, 0.04))
        b.add_frame(f"{side}_sole", f"{side}_foot", position=(0.03, 0.0, -0.05))
    if push_frame:
        b.add_frame("imu", "pelvis", position=(0.0, 0.0, 0.15))
    return b.finalize()


def biped_fleet(lanes, dtype):
    """Bent-knee double support, each lane's joints offset by +-0.02 rad."""
    tree = make_biped(tkin.KinematicTreeBuilder)
    n = tree.num_dofs
    q_nom = np.array([0.25, -0.5, 0.25, 0.25, -0.5, 0.25])
    q = torch.as_tensor(q_nom + np.random.default_rng(0).uniform(-0.02, 0.02, (lanes, n)),
                        dtype=dtype)
    eye = torch.eye(3, dtype=dtype)
    poses = tkin.forward_kinematics(tree, torch.zeros(3, dtype=dtype), eye,
                                    torch.as_tensor(q_nom, dtype=dtype))
    height = -float(tkin.frame_pose(tree, poses, "l_sole")[1][2])
    state = trb.FloatingBaseState(
        base_twist=torch.zeros((lanes, 6), dtype=dtype),
        joint_velocities=torch.zeros((lanes, n), dtype=dtype),
        base_position=torch.tensor([0.0, 0.0, height], dtype=dtype).repeat(lanes, 1),
        base_rotation=eye.repeat(lanes, 1, 1), joint_positions=q)
    poses = tkin.forward_kinematics(tree, state.base_position, state.base_rotation, q)
    return StandingFleet(tree=tree, params=WholeBodyParams(contact_frames=SOLES),
                         state=state, com_ref=trb.com_position(tree, poses), q_ref=q.clone())


def jax_loop(tree, fleet, ticks, eps, backend="pallas"):
    """The balance loop of ``tests/test_wholebody.py:165-209`` for a fleet,
    with ``blf_tpu``: vmapped QP build, one batched solve (on the kernel path
    unless told otherwise), vmapped plant; in the dtype of ``fleet``. ``tree``
    is ``blf_tpu``'s copy of ``fleet.tree``. Returns ``(state, solution)`` of
    every tick."""
    return jax_loop_start(tree, fleet, ticks, eps, backend)()


def jax_loop_start(tree, fleet, ticks, eps, backend="pallas"):
    """:func:`jax_loop` in two halves: its tick is traced now and compiled
    on a thread of its own, so that the caller's port run overlaps the
    compile; the function returned waits for it and runs the ticks. The
    program and its results are those of a plain ``jax.jit``."""
    dtype = jnp.float64 if fleet.q_ref.dtype == torch.float64 else jnp.float32
    as_j = lambda t: jnp.asarray(np.asarray(t), dtype)
    n, nv = tree.num_dofs, tree.nv
    lanes = fleet.q_ref.shape[0]
    params = jwb.WholeBodyParams(contact_frames=SOLES)
    com_ref, q_ref = as_j(fleet.com_ref), as_j(fleet.q_ref)
    gravity = as_j(jrb.GRAVITY)

    def build(state, com_ref, q_ref):
        poses = jkin.forward_kinematics(tree, state.base_position,
                                        state.base_rotation, state.joint_positions)
        com = jrb.com_position(tree, poses)
        com_vel = jrb.com_velocity(
            tree, poses, jnp.concatenate([state.base_twist, state.joint_velocities]))
        task = jwb.WholeBodyTask(
            com_acc_des=100.0 * (com_ref - com) - 20.0 * com_vel,
            base_ang_acc_des=-20.0 * state.base_twist[3:],
            posture_acc_des=100.0 * (q_ref - state.joint_positions)
            - 20.0 * state.joint_velocities,
            contact_active=jnp.ones(2, dtype))
        return jwb.build_wholebody_qp(tree, params, state, task)

    def plant(state, x):
        inp = jrb.FloatingBaseInput(
            joint_torques=x[nv + 12:],
            contact_wrenches={"l_sole": x[nv:nv + 6], "r_sole": x[nv + 6:nv + 12]})
        f = lambda s, u, t: jrb.floating_base_dynamics(tree, s, u, t, rho=1.0,
                                                       gravity=gravity)
        return jax_integrate(f, state, dt=0.0025, num_steps=4, u=inp, method="rk4")

    def tick(state, x0, y0, s0):
        P, q, A, l, u = jax.vmap(build)(state, com_ref, q_ref)
        sol = jax_solve_qp(P, q, A, l, u, iterations=ITERS, check_every=CHECK,
                           x0=x0, y0=y0, s0=s0, eps_abs=eps, eps_rel=eps,
                           backend=backend)
        return jax.vmap(plant)(state, sol.x), sol

    tick = reference_jit(tick, FAST_COMPILE if dtype == jnp.float64 else None)
    state = jrb.FloatingBaseState(**{
        k: as_j(v) for k, v in floating_base_state_to_numpy(fleet.state).items()})
    nx, m = nv + 12 + n, nv + 12 + 22 + n
    x0, y0, s0 = (jnp.zeros((lanes, nx), dtype), jnp.zeros((lanes, m), dtype),
                  jnp.ones((lanes, 1), dtype))
    compiled = in_background(tick.lower(state, x0, y0, s0).compile)

    def run():
        step, carry, history = compiled(), (state, x0, y0, s0), []
        for _ in range(ticks):
            st, sol = step(*carry)
            carry = (st, sol.x, sol.y, sol.rho_scale)
            history.append((st, sol))
        assert all(sol.x.dtype == dtype for _, sol in history)
        return history

    return run


def torch_loop(fleet, ticks, eps, backend="cuda"):
    """The port's loop; ``(state, solution, warm start)`` of every tick."""
    state, warm, history = fleet.state, None, []
    for _ in range(ticks):
        state, sol, warm = wbc_balance_step(fleet, state, warm, backend=backend, eps=eps)
        history.append((state, sol, warm))
    return history


def test_five_ticks_on_the_kernel_backend_match_the_reference():
    lanes, ticks, eps = 4, 5, 1e-5
    fleet = biped_fleet(lanes, torch.float64)
    nv = fleet.tree.nv
    ref = jax_loop_start(make_biped(jkin.KinematicTreeBuilder), fleet, ticks, eps,
                         backend="xla")
    admm_lane.reset_counts()
    linalg.reset_counts()
    out = torch_loop(fleet, ticks, eps)
    ref = ref()
    for k, ((state, sol, warm), (ref_state, ref_sol)) in enumerate(zip(out, ref)):
        for name, val in floating_base_state_to_numpy(state).items():
            np.testing.assert_allclose(val, np.asarray(getattr(ref_state, name)),
                                       atol=1e-6, rtol=0, err_msg=f"tick {k + 1}: {name}")
        np.testing.assert_allclose(sol.torques.numpy(), np.asarray(ref_sol.x[:, nv + 12:]),
                                   atol=1e-6, rtol=0, err_msg=f"tick {k + 1}: torques")
        np.testing.assert_array_equal(sol.qp.converged.numpy(),
                                      np.asarray(ref_sol.converged))
        assert tuple(warm.x.shape) == (lanes, 30) and tuple(warm.y.shape) == (lanes, 52)
    assert bool(sol.qp.converged.all())
    # on CPU tensors the wrappers ran their plain versions, 6 + 6 a tick
    assert admm_lane.reference_count() == linalg.reference_count() == 6 * ticks
    assert admm_lane.launch_count() == linalg.launch_count() == 0
    assert all(bool(torch.isfinite(t).all()) for t in state)
    assert float(state.base_rotation[:, 2, 2].min()) > 0.99


def test_float32_penalty_sinks_alike_on_both_sides():
    lanes, ticks, eps = 8, 20, 1e-4
    fleet = biped_fleet(lanes, torch.float32)
    ref = jax_loop_start(make_biped(jkin.KinematicTreeBuilder), fleet, ticks, eps)
    out = torch_loop(fleet, ticks, eps)
    ref = ref()
    s_port = np.stack([sol.qp.rho_scale.numpy()[:, 0] for _, sol, _ in out])
    s_ref = np.stack([np.asarray(sol.rho_scale)[:, 0] for _, sol in ref])
    assert s_port.dtype == s_ref.dtype == np.float32
    for k, ((_, sol, _), (_, ref_sol)) in enumerate(zip(out, ref)):
        # this robot keeps every lane inside eps on every tick, on both sides
        np.testing.assert_array_equal(sol.qp.converged.numpy(),
                                      np.asarray(ref_sol.converged), err_msg=f"tick {k + 1}")
        assert bool(sol.qp.converged.all()), f"tick {k + 1}"
    for name, s in (("port", s_port), ("reference", s_ref)):
        # the multiplier never rises from one tick to the next, on any lane ...
        assert (np.diff(s, axis=0) <= 0).all(), name
        # ... and ends two to three decades under its cold start of 1
        assert (s[-1] >= 1e-4).all() and (s[-1] <= 1e-2).all(), (name, s[-1])
    # settled, the two sides sit within one step of the rule (x5) of each other
    ratio = s_port[-1] / s_ref[-1]
    assert (ratio > 1 / 5).all() and (ratio < 5).all(), ratio


# ---------------------------------------------------------------------------
# The study: the humanoid's loop in float32, both packages, convergence by tick
# ---------------------------------------------------------------------------

def convergence_row(converged, rp, rd, s):
    f = lambda v: float(f"{float(v):.3g}")
    return [int(np.sum(converged)), f(np.median(rp)), f(np.max(rp)), f(np.median(rd)),
            f(np.max(rd)), f(np.min(s)), f(np.max(s))]


def main():
    lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    eps = 1e-4
    fleet = standing_fleet(lanes, seed=0, device="cpu", dtype=torch.float32)
    t0 = time.perf_counter()
    port = [convergence_row(*(np.asarray(v) for v in (
        sol.qp.converged, sol.qp.primal_residual, sol.qp.dual_residual, sol.qp.rho_scale)))
        for _, sol, _ in torch_loop(fleet, ticks, eps)]
    t1 = time.perf_counter()
    ref = [convergence_row(*(np.asarray(v) for v in (
        sol.converged, sol.primal_residual, sol.dual_residual, sol.rho_scale)))
        for _, sol in jax_loop(jax_humanoid(), fleet, ticks, eps)]
    print(json.dumps({
        "lanes": lanes, "ticks": ticks, "dtype": "float32", "device": "cpu",
        "columns": ["converged", "median_rp", "max_rp", "median_rd", "max_rd",
                    "min_s", "max_s"],
        "blf_tpu_pallas_interpret": ref, "blf_tpu_torch_plain_versions": port,
        "seconds": [round(t1 - t0, 1), round(time.perf_counter() - t1, 1)]}))


if __name__ == "__main__":
    main()
