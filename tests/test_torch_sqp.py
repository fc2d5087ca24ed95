"""The port's batched SQP (``mpc/sqp.py``) against ``blf_tpu.mpc.sqp``.

``tests/test_sqp.py``'s ``TestSQPCore`` problems, fed to both sides from the
same numpy draws: the linear-quadratic problem (also against the port's own
``solve_lqr``: the Gauss-Newton SQP is exact on it), the box-constrained
double integrator (also against scipy's SLSQP, as the reference's test),
the unconstrained problem (no inequality at all: ``ng = 0``), and a
terminal inequality. Float64: states, controls, cost and multipliers within
1e-8, and the same ``converged``. The port's callables take lanes on leading
axes; each reference program is compiled once a process (``run_reference``,
XLA's least optimization) on a thread of its own while the port runs.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from blf_tpu.mpc import sqp as jsqp
from blf_tpu_torch.convert import sqp_solution_to_numpy
from blf_tpu_torch.mpc import riccati as tric
from blf_tpu_torch.mpc import sqp as tsqp
from test_torch_wbc_loop import in_background, run_reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-8, atol=1e-8)
t64 = lambda a: torch.as_tensor(np.array(a, dtype=np.float64))


def assert_matches(got, ref, lane=None):
    """Every field of the port's solution (lane ``lane`` of a batch) against
    the reference's: the arrays within 1e-8, ``converged`` equal."""
    for name, value in sqp_solution_to_numpy(got).items():
        value = value if lane is None else value[lane]
        want = np.asarray(getattr(ref, name))
        if name == "converged":
            assert bool(value) == bool(want), name
        elif name in ("merit_decrease", "gain_norm"):
            continue        # the size of a converged step: rounding on both sides
        else:
            np.testing.assert_allclose(value, want, err_msg=name, **TOL)


# --------------------------------------------------------------------------
# the linear-quadratic problem
# --------------------------------------------------------------------------

LQ_T, LQ_NX, LQ_NU = 15, 4, 2
LQ_CONFIG = dict(iterations=3, al_iterations=1, regularization=0.0)


def lq_problem():
    rng = np.random.default_rng(0)
    F = np.eye(LQ_NX) + 0.05 * rng.normal(size=(LQ_NX, LQ_NX))
    L = 0.1 * rng.normal(size=(LQ_NX, LQ_NU))
    c = 0.01 * rng.normal(size=(LQ_NX,))
    sqQ = rng.normal(size=(LQ_NX, LQ_NX)) * 0.3
    sqR = np.diag(rng.uniform(0.5, 1.0, LQ_NU))
    sqQT = rng.normal(size=(LQ_NX, LQ_NX))
    x0 = rng.normal(size=(LQ_NX,))
    return F, L, c, sqQ, sqR, sqQT, x0


def jax_lq(F, L, c, sqQ, sqR, sqQT, x0):
    return jsqp.solve_trajopt(
        lambda x, u, k: F @ x + L @ u + c,
        lambda x, u, k: jnp.concatenate([sqQ @ x, sqR @ u]),
        lambda x: sqQT @ x, x0, jnp.zeros((LQ_T, LQ_NU)),
        config=jsqp.SQPConfig(**LQ_CONFIG))


def port_lq(F, L, c, sqQ, sqR, sqQT, x0, **config):
    F, L, c, sqQ, sqR, sqQT, x0 = map(t64, (F, L, c, sqQ, sqR, sqQT, x0))
    return tsqp.solve_trajopt(
        lambda x, u, k: x @ F.T + u @ L.T + c,
        lambda x, u, k: torch.cat([x @ sqQ.T, u @ sqR.T], -1),
        lambda x: x @ sqQT.T, x0.reshape((-1, LQ_NX)),
        torch.zeros((x0.reshape(-1, LQ_NX).shape[0], LQ_T, LQ_NU), dtype=torch.float64),
        config=tsqp.SQPConfig(**{**LQ_CONFIG, **config}))


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel_backward"])
def test_lq_problem_matches_the_reference_and_riccati(parallel):
    prob = lq_problem()
    wait = reference("lq")
    got = port_lq(*prob, parallel_backward=parallel)
    assert_matches(got, wait(), lane=0)
    F, L, c, sqQ, sqR, sqQT, x0 = map(t64, prob)
    T = LQ_T
    lqr = tric.solve_lqr(F.expand(T, -1, -1), c.expand(T, -1), L.expand(T, -1, -1),
                         (sqQ.T @ sqQ).expand(T, -1, -1), (sqR.T @ sqR).expand(T, -1, -1),
                         sqQT.T @ sqQT, x0)
    np.testing.assert_allclose(got.states[0].numpy(), lqr.states.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.controls[0].numpy(), lqr.controls.numpy(),
                               rtol=1e-9, atol=1e-9)


def test_lanes_on_a_leading_axis_equal_single_solves():
    F, L, c, sqQ, sqR, sqQT, _ = lq_problem()
    x0s = np.random.default_rng(5).normal(size=(3, LQ_NX))
    batch = port_lq(F, L, c, sqQ, sqR, sqQT, x0s)
    for i in range(3):
        single = port_lq(F, L, c, sqQ, sqR, sqQT, x0s[i])
        np.testing.assert_allclose(batch.states[i].numpy(), single.states[0].numpy(),
                                   rtol=1e-12, atol=1e-12)
        assert bool(batch.converged[i]) == bool(single.converged[0])


# --------------------------------------------------------------------------
# the box-constrained double integrator
# --------------------------------------------------------------------------

DI_T, DI_DT, DI_UMAX, DI_WT = 12, 0.2, 0.35, 30.0
DI_A = np.array([[1.0, DI_DT], [0.0, 1.0]])
DI_B = np.array([0.5 * DI_DT * DI_DT, DI_DT])
DI_TARGET = np.array([1.0, 0.0])
DI_CONFIG = dict(iterations=10, al_iterations=6, penalty_init=10.0)


def jax_di(A, B, target):
    return jsqp.solve_trajopt(
        lambda x, u, k: A @ x + B * u[0], lambda x, u, k: u,
        lambda x: DI_WT * (x - target), jnp.zeros(2), jnp.zeros((DI_T, 1)),
        inequality=lambda x, u, k: jnp.stack([u[0] - DI_UMAX, -DI_UMAX - u[0]]),
        config=jsqp.SQPConfig(**DI_CONFIG))


def port_di():
    A, B, target = t64(DI_A), t64(DI_B), t64(DI_TARGET)
    return tsqp.solve_trajopt(
        lambda x, u, k: x @ A.T + B * u[..., :1], lambda x, u, k: u,
        lambda x: DI_WT * (x - target), torch.zeros((1, 2), dtype=torch.float64),
        torch.zeros((1, DI_T, 1), dtype=torch.float64),
        inequality=lambda x, u, k: torch.cat([u - DI_UMAX, -DI_UMAX - u], -1),
        config=tsqp.SQPConfig(**DI_CONFIG))


def test_constrained_double_integrator_matches_the_reference_and_scipy():
    wait = reference("di")
    got = port_di()
    ref = wait()
    assert_matches(got, ref, lane=0)
    assert got.multipliers.shape == (1, DI_T, 2)

    def cost_np(us):
        x = np.zeros(2)
        for u in us:
            x = DI_A @ x + DI_B * u
        return 0.5 * np.sum(us ** 2) + 0.5 * DI_WT ** 2 * np.sum((x - DI_TARGET) ** 2)

    slsqp = scipy.optimize.minimize(cost_np, np.zeros(DI_T), method="SLSQP",
                                    bounds=[(-DI_UMAX, DI_UMAX)] * DI_T,
                                    options={"maxiter": 400, "ftol": 1e-14})
    assert slsqp.success
    assert float(got.max_violation[0]) <= 1e-6
    np.testing.assert_allclose(float(got.cost[0]), slsqp.fun, rtol=1e-5)
    np.testing.assert_allclose(got.controls[0, :, 0].numpy(), slsqp.x, atol=2e-3)


# --------------------------------------------------------------------------
# no inequality at all, and a terminal inequality
# --------------------------------------------------------------------------

def jax_unconstrained(x0):
    return jsqp.solve_trajopt(
        lambda x, u, k: 0.9 * x + 0.1 * u, lambda x, u, k: jnp.concatenate([x, u]),
        lambda x: x, x0, jnp.zeros((8, 2)), config=jsqp.SQPConfig(iterations=6, al_iterations=2))


def jax_terminal(x0):
    return jsqp.solve_trajopt(
        lambda x, u, k: 0.9 * x + 0.1 * u, lambda x, u, k: jnp.concatenate([x, u]),
        lambda x: x - 1.0, x0, jnp.zeros((8, 2)),
        terminal_inequality=lambda x: x[:1] - 0.3,
        config=jsqp.SQPConfig(iterations=6, al_iterations=3))


def port_small(terminal: bool):
    kw = dict(terminal_inequality=lambda x: x[..., :1] - 0.3) if terminal else {}
    return tsqp.solve_trajopt(
        lambda x, u, k: 0.9 * x + 0.1 * u, lambda x, u, k: torch.cat([x, u], -1),
        (lambda x: x - 1.0) if terminal else (lambda x: x),
        torch.ones((1, 2), dtype=torch.float64), torch.zeros((1, 8, 2), dtype=torch.float64),
        config=tsqp.SQPConfig(iterations=6, al_iterations=3 if terminal else 2), **kw)


def test_unconstrained_converges_as_the_reference():
    wait = reference("unconstrained")
    got = port_small(terminal=False)
    assert_matches(got, wait(), lane=0)
    assert bool(got.converged[0]) and float(got.max_violation[0]) == 0.0
    assert got.multipliers.shape == (1, 8, 0)


def test_terminal_inequality_matches_the_reference():
    wait = reference("terminal")
    got = port_small(terminal=True)
    ref = wait()
    assert_matches(got, ref, lane=0)
    assert float(got.terminal_multipliers[0, 0]) > 1.0      # the bound is active
    assert float(got.max_violation[0]) <= 1e-3              # three AL rounds: nearly feasible


@pytest.fixture(scope="module", autouse=True)
def compile_references():
    """Start every reference solve at once, each on a thread of its own,
    before the first test of the file solves with the port."""
    for name in ("lq", "di", "unconstrained", "terminal"):
        reference(name)


@functools.lru_cache(maxsize=None)
def reference(name):
    """The reference's solve of problem ``name``, compiled once a process on
    a thread of its own; returns a waiter."""
    args = {"lq": (jax_lq, lq_problem()), "di": (jax_di, (DI_A, DI_B, DI_TARGET)),
            "unconstrained": (jax_unconstrained, (np.ones(2),)),
            "terminal": (jax_terminal, (np.ones(2),))}[name]
    return in_background(run_reference, args[0], *args[1])
