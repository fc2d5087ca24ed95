"""The port's Riccati solvers (``mpc/riccati.py``) and its log-depth scan
(``ops/scan.py``) against ``blf_tpu.mpc.riccati`` and
``jax.lax.associative_scan``.

The problems are ``tests/test_riccati.py``'s (``random_lqr``, the general
value pass's ``_problem``), drawn with numpy and fed to both sides. Float64;
the two sides factor and sum in other orders, so 1e-9, never bit for bit.
Each reference program is compiled once a process (``reference_jit``, XLA's
least optimization: at its default optimization the jitted ``solve_lqr``
corrupts the heap of this container's jaxlib on the CPU; see ROADMAP.md
section 3) on a thread of its own while the port runs. The sharded solve is
held here on a world of one, and across ranks in
``tests/test_torch_sharding.py``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from blf_tpu.mpc import riccati as jric
from blf_tpu_torch.convert import lqr_problem_from_numpy, lqr_solution_to_numpy
from blf_tpu_torch.mpc import riccati as tric
from blf_tpu_torch.ops.scan import associative_scan
from test_torch_wbc_loop import in_background, reference_jit
from torch_spmd import world_of_one

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-9)


def random_lqr(T=24, nx=4, nu=2, rng=None):
    """``tests/test_riccati.py::random_lqr``'s draws, as numpy arrays."""
    Fs = np.stack([np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)) for _ in range(T)])
    cs = rng.normal(size=(T, nx)) * 0.1
    Ls = rng.normal(size=(T, nx, nu)) * 0.3
    Qs = np.stack([np.eye(nx) * rng.uniform(0.5, 2.0) for _ in range(T)])
    Rs = np.stack([np.eye(nu) * rng.uniform(0.1, 1.0) for _ in range(T)])
    QT = np.eye(nx) * 5.0
    x0 = rng.normal(size=nx)
    return Fs, cs, Ls, Qs, Rs, QT, x0


def general_problem(T=24, nx=5, nu=3, seed=0):
    """``tests/test_riccati.py::TestGeneralParallelValue._problem``."""
    rng = np.random.default_rng(seed)
    A = np.stack([np.eye(nx) + 0.08 * rng.normal(size=(nx, nx)) for _ in range(T)])
    B = rng.normal(size=(T, nx, nu)) * 0.4
    lx = rng.normal(size=(T, nx)) * 0.3
    lu = rng.normal(size=(T, nu)) * 0.3
    Ms = rng.normal(size=(T, nx, nx))
    lxx = Ms @ np.swapaxes(Ms, -1, -2) * 0.1 + np.eye(nx) * 0.5
    Mu = rng.normal(size=(T, nu, nu))
    luu = Mu @ np.swapaxes(Mu, -1, -2) * 0.1 + np.eye(nu)
    lux = rng.normal(size=(T, nu, nx)) * 0.2
    VxT = rng.normal(size=nx)
    MT = rng.normal(size=(nx, nx))
    VxxT = MT @ MT.T * 0.1 + np.eye(nx) * 2.0
    return A, B, lx, lu, lxx, luu, lux, VxT, VxxT


def both_forms(*prob):
    return jric.solve_lqr(*prob, parallel=False), jric.solve_lqr(*prob, parallel=True)


@functools.lru_cache(maxsize=None)
def reference(T):
    """Both forms of the reference's ``solve_lqr`` on ``random_lqr(T)``, one
    program a horizon, compiled on a thread; returns a waiter."""
    prob = random_lqr(T, 4, 2, np.random.default_rng(T))
    exe = reference_jit(both_forms).lower(*prob)
    return in_background(lambda: exe.compile()(*prob))


@functools.lru_cache(maxsize=None)
def reference_general():
    prob = general_problem()
    exe = reference_jit(jric.parallel_value_general).lower(*prob)
    return in_background(lambda: exe.compile()(*prob))


@pytest.fixture(scope="module", autouse=True)
def compile_references():
    """Start every reference program's compile at once, each on a thread of
    its own, before the first test of the file solves with the port."""
    for T in (4, 17, 64):
        reference(T)
    reference_general()


def port(prob, **kw):
    return tric.solve_lqr(*lqr_problem_from_numpy(*prob, device="cpu", dtype=torch.float64),
                          **kw)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
@pytest.mark.parametrize("T", [4, 17, 64])
def test_solve_lqr_matches_the_reference(T, parallel):
    wait = reference(T)
    got = port(random_lqr(T, 4, 2, np.random.default_rng(T)), parallel=parallel)
    ref = wait()[int(parallel)]
    for name, value in lqr_solution_to_numpy(got).items():
        np.testing.assert_allclose(value, np.asarray(getattr(ref, name)), err_msg=name, **TOL)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_a_batch_equals_each_single_solve(parallel):
    """Three problems on a leading batch axis (and, as the reference's
    ``test_jit_and_vmap`` does, one problem from eight initial states)."""
    probs = [random_lqr(17, 4, 2, np.random.default_rng(s)) for s in (1, 2, 3)]
    batch = port(tuple(np.stack(parts) for parts in zip(*probs)), parallel=parallel)
    for i, prob in enumerate(probs):
        single = port(prob, parallel=parallel)
        for name, value in lqr_solution_to_numpy(single).items():
            np.testing.assert_allclose(lqr_solution_to_numpy(batch)[name][i], value,
                                       rtol=1e-12, atol=1e-12, err_msg=name)
    prob = random_lqr(16, 4, 2, np.random.default_rng(9))
    x0s = np.random.default_rng(3).normal(size=(8, 4))
    fleet = port(prob[:-1] + (x0s,), parallel=parallel)
    assert fleet.controls.shape == (8, 16, 2) and fleet.gains.shape == (8, 16, 2, 4)
    solo = port(prob[:-1] + (x0s[5],), parallel=parallel)
    np.testing.assert_allclose(fleet.controls[5].numpy(), solo.controls.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_matches_condensed_least_squares():
    """``TestSequential.test_matches_condensed_least_squares``: against an
    independent dense solve of the same quadratic program."""
    T, nx, nu = 8, 3, 2
    Fs, cs, Ls, Qs, Rs, QT, x0 = random_lqr(T, nx, nu, np.random.default_rng(2))
    sol = port((Fs, cs, Ls, Qs, Rs, QT, x0))
    G = np.zeros(((T + 1) * nx, T * nu))
    d = np.zeros((T + 1) * nx)
    Phi = np.zeros(((T + 1) * nx, nx))
    Phi[:nx] = np.eye(nx)
    for k in range(T):
        Phi[(k + 1) * nx:(k + 2) * nx] = Fs[k] @ Phi[k * nx:(k + 1) * nx]
        d[(k + 1) * nx:(k + 2) * nx] = Fs[k] @ d[k * nx:(k + 1) * nx] + cs[k]
        for j in range(k + 1):
            blk = np.eye(nx)
            for i in range(k, j, -1):
                blk = blk @ Fs[i]
            G[(k + 1) * nx:(k + 2) * nx, j * nu:(j + 1) * nu] = blk @ Ls[j]
    Qbig = np.zeros(((T + 1) * nx, (T + 1) * nx))
    Rbig = np.zeros((T * nu, T * nu))
    for k in range(T):
        Qbig[k * nx:(k + 1) * nx, k * nx:(k + 1) * nx] = Qs[k]
        Rbig[k * nu:(k + 1) * nu, k * nu:(k + 1) * nu] = Rs[k]
    Qbig[T * nx:, T * nx:] = QT
    H = G.T @ Qbig @ G + Rbig
    u_ref = np.linalg.solve(H, -(G.T @ Qbig @ (Phi @ x0 + d)))
    np.testing.assert_allclose(sol.controls.numpy().ravel(), u_ref, atol=1e-8)


def sequential_general(A, B, lx, lu, lxx, luu, lux, VxT, VxxT):
    """``TestGeneralParallelValue._sequential``: the backward recursion in numpy."""
    Vx, Vxx = VxT, VxxT
    Vxs, Vxxs = [Vx], [Vxx]
    for k in reversed(range(A.shape[0])):
        Qx = lx[k] + A[k].T @ Vx
        Qu = lu[k] + B[k].T @ Vx
        Qxx = lxx[k] + A[k].T @ Vxx @ A[k]
        Quu = luu[k] + B[k].T @ Vxx @ B[k]
        Qux = lux[k] + B[k].T @ Vxx @ A[k]
        K = np.linalg.solve(Quu, Qux)
        kff = np.linalg.solve(Quu, Qu)
        Vx = Qx + K.T @ Quu @ kff - K.T @ Qu - Qux.T @ kff
        Vxx = Qxx + K.T @ Quu @ K - K.T @ Qux - Qux.T @ K
        Vxx = 0.5 * (Vxx + Vxx.T)
        Vxs.append(Vx)
        Vxxs.append(Vxx)
    return np.stack(Vxs[::-1]), np.stack(Vxxs[::-1])


def test_parallel_value_general_matches_the_reference():
    prob = general_problem()
    Vxs, Vxxs = tric.parallel_value_general(*(torch.as_tensor(a) for a in prob))
    ref_Vxs, ref_Vxxs = reference_general()()
    np.testing.assert_allclose(Vxs.numpy(), np.asarray(ref_Vxs), **TOL)
    np.testing.assert_allclose(Vxxs.numpy(), np.asarray(ref_Vxxs), **TOL)
    seq_Vxs, seq_Vxxs = sequential_general(*prob)
    np.testing.assert_allclose(Vxs.numpy(), seq_Vxs, atol=1e-8)
    np.testing.assert_allclose(Vxxs.numpy(), seq_Vxxs, atol=1e-8)
    # lanes on a leading axis: two problems at once, each its own solve
    other = general_problem(seed=1)
    stacked = [torch.as_tensor(np.stack(p)) for p in zip(prob, other)]
    both_Vxs, both_Vxxs = tric.parallel_value_general(*stacked)
    np.testing.assert_allclose(both_Vxs[0].numpy(), Vxs.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(both_Vxxs[1].numpy(), sequential_general(*other)[1], atol=1e-8)


def test_general_value_reduces_to_plain_lqr():
    """``test_reduces_to_plain_lqr``: no cross or linear terms, so the
    general pass is ``solve_lqr``'s parallel value function."""
    rng = np.random.default_rng(3)
    T, nx, nu = 16, 4, 2
    Fs = np.stack([np.eye(nx) + 0.05 * rng.normal(size=(nx, nx)) for _ in range(T)])
    Ls = rng.normal(size=(T, nx, nu)) * 0.3
    Qs = np.stack([np.eye(nx)] * T)
    Rs = np.stack([np.eye(nu) * 0.5] * T)
    QT = np.eye(nx) * 5.0
    x0 = rng.normal(size=nx)
    ref = port((Fs, np.zeros((T, nx)), Ls, Qs, Rs, QT, x0), parallel=True)
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    _, Vxxs = tric.parallel_value_general(t(Fs), t(Ls), t(np.zeros((T, nx))),
                                          t(np.zeros((T, nu))), t(Qs), t(Rs),
                                          t(np.zeros((T, nu, nx))), t(np.zeros(nx)), t(QT))
    np.testing.assert_allclose(Vxxs.numpy(), ref.value_matrices.numpy(), atol=1e-8)


def test_sharded_solve_waits_for_the_multi_device_slice():
    """The horizon-sharded solve on a world of one (this process, ``gloo``)
    against the reference's on a mesh of one device and against the port's
    ``solve_lqr``; ``tests/test_torch_sharding.py`` holds it at 2 and 4
    ranks."""
    from jax.sharding import Mesh

    prob = random_lqr(8, 4, 2, np.random.default_rng(0))
    mesh = Mesh(np.array(jax.devices()[:1]), ("seq",))
    ref = in_background(reference_jit(lambda *a: jric.solve_lqr_sharded(*a, mesh, "seq")),
                        *prob)
    with world_of_one(axis_names=("data", "seq")) as tmesh:
        got = tric.solve_lqr_sharded(*lqr_problem_from_numpy(*prob, device="cpu",
                                                            dtype=torch.float64), tmesh, "seq")
    one = tric.solve_lqr(*lqr_problem_from_numpy(*prob, device="cpu", dtype=torch.float64))
    ref = ref()
    for name, value in lqr_solution_to_numpy(got).items():
        np.testing.assert_allclose(value, np.asarray(getattr(ref, name)), err_msg=name, **TOL)
        np.testing.assert_allclose(value, getattr(one, name).numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("T", [1, 2, 7, 16])
def test_reverse_scan_is_the_suffix_scan_of_jax(T):
    """``associative_scan(reverse=True)`` against
    ``jax.lax.associative_scan(reverse=True)`` with a combine that is
    associative but not commutative (2 x 2 matrix products): the port's
    ``fn`` keeps (earlier, later) in the original order, JAX's gets the
    later element first, as the reference's ``_suffix_scan`` knows."""
    mats = np.random.default_rng(T).normal(size=(T, 3, 2, 2))
    (got,) = associative_scan(lambda a, b: (a[0] @ b[0],), (torch.as_tensor(mats),),
                              reverse=True)
    ref = reference_jit(lambda m: jax.lax.associative_scan(lambda a, b: b @ a, m,
                                                            reverse=True))(mats)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-12)
    acc = mats[-1]
    for k in range(T - 2, -1, -1):
        acc = mats[k] @ acc
        np.testing.assert_allclose(got[k].numpy(), acc, rtol=1e-12, atol=1e-12)
