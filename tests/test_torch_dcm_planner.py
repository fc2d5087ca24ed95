"""The port's time-varying DCM planner (``mpc/dcm_planner.py``) against
``blf_tpu.mpc.dcm_planner``.

``tests/test_sqp.py``'s ``TestDCMPlanner`` and ``TestParallelBackward``
problems (``_planner_problem``: four footholds, square polygons), fed to
both sides from the same numpy arrays:

* float64, within 1e-8 on ``dcm``, ``omega``, ``zmp``, ``omega_dot`` and
  ``vrp``, with the same ``converged``: the consistent problem, push
  recovery (each a single plan of the port), a batch of four pushed lanes
  (``plan_time_varying_dcm_batch``), and the parallel backward pass at
  T = 16; the omega mismatch within 5e-7: on it the reference's own single
  and batched programs part by 7.7e-8 on ``omega_dot`` and 1.4e-8 on
  ``vrp`` (omega_dot weighs 0.1 there and is loosely pinned), and the port
  lies within 1.8e-7 and 3.1e-8 of the batched one;
* ``_dcm_step`` and ``com_from_dcm_omega`` within 1e-12;
* float32: push recovery within 2e-4 of the reference's float32 plan.

The reference's float64 plans come from one program, its batch of four
lanes with the weights, limits and polygons traced, compiled once a process
(XLA's least optimization) on a thread of its own: a single problem is that
program's lane 0 (the reference's own ``test_batched_matches_single`` holds
a lane to its single plan to 1e-10). Each test also holds the port's plan to
the reference test's own checks.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models import lipm as jlipm
from blf_tpu.mpc import dcm_planner as jdp
from blf_tpu.mpc import sqp as jsqp
from blf_tpu_torch.convert import dcm_planner_solution_to_numpy, lipm_params_from_numpy
from blf_tpu_torch.mpc import dcm_planner as tdp
from blf_tpu_torch.mpc.sqp import SQPConfig
from test_torch_wbc_loop import FAST_COMPILE, in_background, reference_jit

torch.set_num_threads(1)

DT, Z_NOM, G = 0.1, 0.9, 9.81
OMEGA = float(np.sqrt(G / Z_NOM))
FIELDS = ("dcm", "omega", "zmp", "omega_dot", "vrp")
LANES = 4


def planner_problem(T=30, margin=0.12):
    """``tests/test_sqp.py::_planner_problem`` in numpy, with the DCM
    backward recursion's reference and the goal at its end."""
    steps = np.array([[0.0, 0.0], [0.15, 0.1], [0.3, -0.1], [0.45, 0.0]])
    zmp_ref = np.repeat(steps, T // len(steps), axis=0)
    T = zmp_ref.shape[0]
    poly_A = np.tile(np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]]), (T, 1, 1))
    poly_b = np.stack([zmp_ref[:, 0] + margin, -(zmp_ref[:, 0] - margin),
                       zmp_ref[:, 1] + margin, -(zmp_ref[:, 1] - margin)], -1)
    a = np.exp(-OMEGA * DT)
    xy = [zmp_ref[-1]]
    for k in range(T - 1, -1, -1):
        xy.append(zmp_ref[k] + a * (xy[-1] - zmp_ref[k]))
    xy_ref = np.stack(xy[::-1])
    goal = np.append(xy_ref[-1], Z_NOM)
    return zmp_ref, poly_A, poly_b, xy_ref, goal


def jax_batch(sqp, dcm0, omega0, zmp_ref, poly_A, poly_b, goal, weights, limits):
    params = jlipm.LIPMParams(jnp.asarray(Z_NOM, zmp_ref.dtype), jnp.asarray(G, zmp_ref.dtype))
    return jdp.plan_time_varying_dcm_batch(params, DT, dcm0, omega0, zmp_ref, poly_A, poly_b,
                                           goal, weights=weights, limits=limits, sqp=sqp)


def as_arrays(named):
    return type(named)(*(np.asarray(float(v)) for v in named))


@functools.lru_cache(maxsize=None)
def reference_program(T, lanes, dtype, parallel=False):
    """The reference's batched plan, compiled once for these static
    arguments on a thread of its own; returns a waiter for the executable."""
    sqp = (jsqp.SQPConfig(parallel_backward=True, iterations=8, al_iterations=3,
                          penalty_init=10.0) if parallel
           else jsqp.SQPConfig(iterations=10, al_iterations=5, penalty_init=10.0))
    zmp_ref, poly_A, poly_b, xy_ref, goal = planner_problem(T)
    example = [np.zeros((lanes, 3)), np.zeros(lanes), zmp_ref, poly_A, poly_b, goal,
               as_arrays(jdp.DCMPlannerWeights()), as_arrays(jdp.DCMPlannerLimits())]
    example = [np.asarray(a, dtype) if isinstance(a, np.ndarray) else
               type(a)(*(np.asarray(v, dtype) for v in a)) for a in example]
    options = FAST_COMPILE if dtype == np.float64 else None
    lowered = reference_jit(functools.partial(jax_batch, sqp), options).lower(*example)
    return in_background(lowered.compile)


def reference(T, dcm0, omega0, margin, weights, lanes=LANES, dtype=np.float64, parallel=False):
    """The reference's plans of ``dcm0`` (lanes, 3) / ``omega0`` (lanes,)."""
    zmp_ref, poly_A, poly_b, _, goal = planner_problem(T, margin)
    args = [dcm0, omega0, zmp_ref, poly_A, poly_b, goal, as_arrays(weights),
            as_arrays(jdp.DCMPlannerLimits())]
    args = [np.asarray(a, dtype) if isinstance(a, np.ndarray) else
            type(a)(*(np.asarray(v, dtype) for v in a)) for a in args]
    return reference_program(T, lanes, dtype, parallel)()(*args)


def port_single(T, dcm0, omega0, margin, dtype=torch.float64, **kw):
    zmp_ref, poly_A, poly_b, _, goal = planner_problem(T, margin)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    return tdp.plan_time_varying_dcm(
        lipm_params_from_numpy(Z_NOM, G, device="cpu", dtype=dtype), DT, t(dcm0), t(omega0),
        t(zmp_ref), t(poly_A), t(poly_b), t(goal), **kw)


def lanes_of(first_dcm0, first_omega0, seed=3):
    """Lane 0 is the problem; the others are pushed lanes around it."""
    rng = np.random.default_rng(seed)
    dcm0 = np.tile(first_dcm0, (LANES, 1))
    dcm0[1:, :2] += rng.uniform(-0.03, 0.03, (LANES - 1, 2))
    return dcm0, np.full(LANES, float(first_omega0))


@pytest.fixture(scope="module", autouse=True)
def compile_references():
    """Start every reference program's compile at once, each on a thread of
    its own, before the first test of the file plans with the port."""
    for args in ((30, LANES, np.float64), (16, 1, np.float64, True), (30, 1, np.float32)):
        reference_program(*args)


def assert_lane_matches(got, ref, lane, tol=1e-8):
    got = dcm_planner_solution_to_numpy(got)
    for name in FIELDS:
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name))[lane],
                                   rtol=tol, atol=tol, err_msg=name)
    assert bool(got["converged"]) == bool(np.asarray(ref.converged)[lane])


def test_consistent_problem_matches_the_reference_and_the_analytic_recursion():
    _, _, _, xy_ref, goal = planner_problem()
    dcm0 = np.append(xy_ref[0], Z_NOM)
    reference_program(30, LANES, np.float64)            # compile while the port plans
    got = port_single(30, dcm0, OMEGA, 0.12)
    ref = reference(30, *lanes_of(dcm0, OMEGA), 0.12, jdp.DCMPlannerWeights())
    assert_lane_matches(got, ref, 0)
    assert bool(got.converged) and float(got.cost) < 1e-10
    np.testing.assert_allclose(got.dcm[:, :2].numpy(), xy_ref, atol=1e-8)
    np.testing.assert_allclose(got.omega.numpy(), OMEGA, atol=1e-9)
    np.testing.assert_allclose(got.vrp[:, 2].numpy(), Z_NOM, atol=1e-8)


def test_push_recovery_matches_the_reference():
    zmp_ref, poly_A, poly_b, xy_ref, goal = planner_problem(margin=0.08)
    dcm0 = np.append(xy_ref[0] + [0.06, -0.05], Z_NOM)
    reference_program(30, LANES, np.float64)
    got = port_single(30, dcm0, OMEGA, 0.08)
    ref = reference(30, *lanes_of(dcm0, OMEGA), 0.08, jdp.DCMPlannerWeights())
    assert_lane_matches(got, ref, 0)
    assert float(got.max_violation) <= 1e-6
    assert float((np.einsum("tmi,ti->tm", poly_A, got.zmp.numpy()) - poly_b).max()) <= 1e-6
    assert float(np.abs(got.zmp.numpy() - zmp_ref).max()) > 1e-3
    np.testing.assert_allclose(got.dcm[-1].numpy(), goal, atol=2e-3)
    assert abs(float(got.omega[-1]) - OMEGA) < 5e-2


def test_omega_mismatch_matches_the_reference():
    _, _, _, xy_ref, goal = planner_problem()
    dcm0 = np.append(xy_ref[0], Z_NOM + 0.1)
    weights = jdp.DCMPlannerWeights(omega_tracking=0.3, omega_dot=0.1)
    reference_program(30, LANES, np.float64)
    got = port_single(30, dcm0, 1.25 * OMEGA, 0.12,
                      weights=tdp.DCMPlannerWeights(omega_tracking=0.3, omega_dot=0.1))
    ref = reference(30, *lanes_of(dcm0, 1.25 * OMEGA), 0.12, weights)
    assert_lane_matches(got, ref, 0, tol=5e-7)
    assert float(got.max_violation) <= 1e-6
    assert float(got.omega_dot.abs().max()) > 1e-2
    assert abs(float(got.omega[-1]) - OMEGA) < 0.05
    np.testing.assert_allclose(got.dcm[-1].numpy(), goal, atol=5e-3)


def test_batch_matches_the_reference_batch():
    zmp_ref, poly_A, poly_b, xy_ref, goal = planner_problem(margin=0.08)
    dcm0, omega0 = lanes_of(np.append(xy_ref[0], Z_NOM), OMEGA, seed=4)
    dcm0[0, :2] += [0.02, -0.01]
    reference_program(30, LANES, np.float64)
    t = lambda a: torch.as_tensor(np.asarray(a))
    got = tdp.plan_time_varying_dcm_batch(
        lipm_params_from_numpy(Z_NOM, G, device="cpu", dtype=torch.float64), DT, t(dcm0),
        t(omega0), t(zmp_ref), t(poly_A), t(poly_b), t(goal))
    assert got.dcm.shape == (LANES, 29, 3) and got.converged.shape == (LANES,)
    ref = reference(30, dcm0, omega0, 0.08, jdp.DCMPlannerWeights())
    for lane in range(LANES):
        assert_lane_matches(tdp.DCMPlannerSolution(*(f[lane] for f in got)), ref, lane)


def test_parallel_backward_matches_the_reference():
    """``TestParallelBackward`` at T = 16: the port's parallel pass against
    the reference's, and against the port's own sequential pass (1e-6, the
    reference test's float64 limit)."""
    _, _, _, xy_ref, goal = planner_problem(16)
    dcm0 = np.append(xy_ref[0] + [0.04, -0.03], Z_NOM)
    reference_program(16, 1, np.float64, parallel=True)
    kw = dict(iterations=8, al_iterations=3, penalty_init=10.0)
    par = port_single(16, dcm0, OMEGA, 0.12, sqp=SQPConfig(parallel_backward=True, **kw))
    seq = port_single(16, dcm0, OMEGA, 0.12, sqp=SQPConfig(**kw))
    ref = reference(16, dcm0[None], np.array([OMEGA]), 0.12, jdp.DCMPlannerWeights(), lanes=1,
                    parallel=True)
    assert_lane_matches(par, ref, 0)
    np.testing.assert_allclose(par.dcm.numpy(), seq.dcm.numpy(), atol=1e-6)
    np.testing.assert_allclose(par.zmp.numpy(), seq.zmp.numpy(), atol=1e-6)
    assert abs(float(par.max_violation) - float(seq.max_violation)) <= 1e-6


def test_push_recovery_in_float32_matches_the_reference_float32_plan():
    """Float32 on both sides (the reference at XLA's default optimization,
    its own float32 rounding), within 2e-4, the reference test's float32
    limit; and the float32 checks of that test on the port's plan."""
    zmp_ref, poly_A, poly_b, xy_ref, goal = planner_problem(margin=0.08)
    dcm0 = np.append(xy_ref[0] + [0.06, -0.05], Z_NOM)
    reference_program(30, 1, np.float32)
    got = port_single(30, dcm0, OMEGA, 0.08, dtype=torch.float32)
    assert got.dcm.dtype == torch.float32
    ref = reference(30, dcm0[None], np.array([OMEGA]), 0.08, jdp.DCMPlannerWeights(), lanes=1,
                    dtype=np.float32)
    assert np.asarray(ref.dcm).dtype == np.float32
    assert_lane_matches(got, ref, 0, tol=2e-4)
    assert float(got.max_violation) <= 2e-4
    assert float((np.einsum("tmi,ti->tm", poly_A, got.zmp.numpy()) - poly_b).max()) <= 2e-4
    np.testing.assert_allclose(got.dcm[-1].numpy(), goal, atol=2e-3)


def test_dcm_step_and_com_integration_match_the_reference():
    """``test_exact_step_reduces_to_lipm_discrete_step`` and
    ``test_com_integration_exactness`` on both sides, within 1e-12."""
    GRAVITY = torch.tensor(G, dtype=torch.float64)
    x = np.array([0.1, -0.05, 0.85, float(np.sqrt(G / 0.85))])
    rng = np.random.default_rng(7)
    for u in (np.array([0.02, 0.01, 0.0]), np.array([0.02, 0.01, 0.3])):
        ref = jdp._dcm_step(jnp.asarray(x), jnp.asarray(u), 0.07, jnp.asarray(G), 0.0)
        got = tdp._dcm_step(torch.as_tensor(x), torch.as_tensor(u), 0.07, GRAVITY, 0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    xs = x + 0.01 * rng.normal(size=(5, 4))         # lanes on a leading axis
    us = rng.uniform(-0.1, 0.1, (5, 3))
    got = tdp._dcm_step(torch.as_tensor(xs), torch.as_tensor(us), 0.07, GRAVITY, 0.0)
    for i in range(5):
        ref = jdp._dcm_step(jnp.asarray(xs[i]), jnp.asarray(us[i]), 0.07, jnp.asarray(G), 0.0)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)

    T = 40
    dcm = np.broadcast_to([0.3, -0.1, 0.9], (T + 1, 3)) + 0.01 * rng.normal(size=(T + 1, 3))
    omega = 3.2 + 0.1 * rng.normal(size=(2, T + 1))
    com0 = np.array([[0.0, 0.0, 0.8], [0.1, 0.0, 0.8]])
    ref = jdp.com_from_dcm_omega(jnp.asarray(com0), jnp.asarray(dcm), jnp.asarray(omega), 0.05)
    got = tdp.com_from_dcm_omega(torch.as_tensor(com0), torch.as_tensor(dcm),
                                 torch.as_tensor(omega), 0.05)
    assert got.shape == (2, T + 1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
