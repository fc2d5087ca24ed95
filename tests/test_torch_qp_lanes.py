"""The port's per-lane QP solvers against ``blf_tpu.mpc.qp``'s.

``solve_qp`` (``backend="torch"`` against the reference's ``"xla"``) and
``solve_qp_lanes`` (the kernels' plain versions on the CPU against the
reference's Pallas kernels in interpret mode), float64, on the fleet of
``tests/test_qp.py::TestPerLaneFused`` (B = 5, n = 12, m = 18, four equality
rows, one one-sided row), with the same iteration counts on both sides.

Tolerances: both sides run one recursion in two evaluation orders, so the
iterates agree to about 1e-12 a stage, and ADMM is a contraction near its
fixed point: ``TIGHT`` = 1e-8 on every field after 50 iterations and at the
converged end. In between, the penalty rule feeds rounding back: ``rho_scale``
moves by sqrt(r_prim / r_dual), and a lane whose one residual is already tiny
carries 1e-5..1e-4 relative noise in that ratio (seen: s differs by 3.6e-5
where x agrees to 5e-13). The next stage runs at that s, so a lane still on
its way differs by up to 2e-6 in x and 6e-5 in y at 100-125 iterations and
then contracts again: ``LOOSE`` = 1e-4 there. Once a lane has converged to
rounding, ``solve_qp``'s rule (no hysteresis) moves s by pure noise, so
``rho_scale`` is compared only where the residuals are far from their floor
(ROADMAP.md section 3, the rho rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.mpc import dcm as jdcm
from blf_tpu.mpc import qp as jqp
from blf_tpu_torch.convert import lipm_params_from_numpy, qp_solution_to_numpy
from blf_tpu_torch.mpc import dcm as tdcm
from blf_tpu_torch.mpc import qp as tqp
from blf_tpu_torch.ops.cuda import admm_lane, linalg
from test_torch_wbc_loop import run_reference

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

TIGHT = 1e-8
LOOSE = 1e-4
FIELDS = ("x", "y", "z", "primal_residual", "dual_residual", "objective")


def make_fleet(B=5, n=12, m=18, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(B, n, n)) * 0.5
    P = P @ np.swapaxes(P, -1, -2) + np.eye(n)
    q = rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n))
    xs = rng.normal(size=(B, n))
    Ax = np.einsum("bmn,bn->bm", A, xs)
    l = Ax - np.abs(rng.normal(size=(B, m))) * 0.5
    u = Ax + np.abs(rng.normal(size=(B, m))) * 0.5
    l[:, :4] = u[:, :4] = Ax[:, :4]      # feasible equality rows
    l[:, 5] = -np.inf                    # one-sided row
    return P, q, A, l, u


def to_j(args):
    return tuple(jnp.asarray(a) for a in args)


def to_t(args, dtype=torch.float64):
    return tuple(torch.as_tensor(np.array(a), dtype=dtype) for a in args)


def assert_same_solution(sol_t, sol_j, atol=TIGHT, s_rtol=None):
    got = qp_solution_to_numpy(sol_t)
    for name in FIELDS:
        ref = np.asarray(getattr(sol_j, name))
        assert got[name].shape == ref.shape, name
        np.testing.assert_allclose(got[name], ref, atol=atol, rtol=atol, err_msg=name)
    np.testing.assert_array_equal(got["converged"], np.asarray(sol_j.converged))
    assert got["rho_scale"].shape == np.asarray(sol_j.rho_scale).shape
    if s_rtol is not None:
        np.testing.assert_allclose(got["rho_scale"], np.asarray(sol_j.rho_scale),
                                   rtol=s_rtol, err_msg="rho_scale")


@pytest.mark.parametrize("kw,s_rtol", [
    (dict(iterations=50), 1e-6),
    (dict(iterations=400, eps_abs=1e-4, eps_rel=1e-4), None),
    (dict(iterations=120), None),
    (dict(iterations=100, kkt_inverse=False), None),
    (dict(iterations=100, polish_iters=10, check_every=20), None),
], ids=["50", "400_eps1e-4", "120", "cho_solve", "polish"])
def test_solve_qp_matches_the_reference(kw, s_rtol):
    args = make_fleet()
    sol_j = run_reference(jqp.solve_qp, *to_j(args), **kw)
    sol_t = tqp.solve_qp(*to_t(args), **kw)
    assert_same_solution(sol_t, sol_j, s_rtol=s_rtol)
    s = sol_t.rho_scale
    assert bool(((s >= 1e-6) & (s <= 1e6)).all())
    assert sol_t.refined is None and sol_j.refined is None
    assert tuple(sol_t.rho_scale.shape) == (5, 1)


@pytest.mark.parametrize("kw,atol", [
    (dict(iterations=50), TIGHT),
    (dict(iterations=400, eps_abs=1e-4, eps_rel=1e-4), TIGHT),
    (dict(iterations=120), LOOSE),
    (dict(iterations=100, polish_iters=10, check_every=20), LOOSE),
], ids=["50", "400_eps1e-4", "120", "polish"])
def test_solve_qp_lanes_matches_the_reference(kw, atol):
    args = make_fleet()
    sol_j = jqp.solve_qp_lanes(*to_j(args), **kw)
    admm_lane.reset_counts()
    linalg.reset_counts()
    sol_t = tqp.solve_qp_lanes(*to_t(args), **kw)
    assert_same_solution(sol_t, sol_j, atol=atol, s_rtol=1e-3)
    assert sol_t.refined is not None and not bool(sol_t.refined)
    # on CPU tensors the wrappers ran their plain versions, once a stage each
    stages = -(-kw["iterations"] // kw.get("check_every", 25)) + (
        1 if kw.get("polish_iters") else 0)
    assert admm_lane.reference_count() == linalg.reference_count() == stages
    assert admm_lane.launch_count() == linalg.launch_count() == 0


def test_the_two_paths_agree_as_the_reference_holds_them():
    """``tests/test_qp.py::test_matches_xla_path``: 1e-4 in float64."""
    args = to_t(make_fleet())
    kw = dict(iterations=400, eps_abs=1e-4, eps_rel=1e-4)
    ref = tqp.solve_qp(*args, **kw)
    lane = tqp.solve_qp_lanes(*args, **kw)
    np.testing.assert_allclose(lane.x.numpy(), ref.x.numpy(), atol=1e-4)


def test_backend_dispatch():
    args = to_t(make_fleet(seed=1))
    via_backend = tqp.solve_qp(*args, iterations=120, backend="cuda")
    direct = tqp.solve_qp_lanes(*args, iterations=120)
    assert torch.equal(via_backend.x, direct.x)
    assert via_backend.refined is not None
    with pytest.raises(ValueError, match="unknown solve_qp backend"):
        tqp.solve_qp(*args, backend="pallas")


def test_warm_start_converges_and_polish():
    args = make_fleet(seed=2)
    kw = dict(eps_abs=1e-4, eps_rel=1e-4)
    cold_j = jqp.solve_qp_lanes(*to_j(args), iterations=400, **kw)
    warm_j = jqp.solve_qp_lanes(*to_j(args), iterations=50, x0=cold_j.x, y0=cold_j.y,
                                s0=cold_j.rho_scale, polish_iters=10, **kw)
    x0, y0, s0 = to_t((cold_j.x, cold_j.y, cold_j.rho_scale))
    warm_t = tqp.solve_qp_lanes(*to_t(args), iterations=50, x0=x0, y0=y0, s0=s0,
                                polish_iters=10, **kw)
    assert bool(warm_t.converged.all())
    assert_same_solution(warm_t, warm_j, atol=LOOSE)
    # solve_qp takes the same warm start, s0 as (B, 1) or (B,)
    warm_q = tqp.solve_qp(*to_t(args), iterations=50, x0=x0, y0=y0, s0=s0[:, 0], **kw)
    warm_qj = run_reference(jqp.solve_qp, *to_j(args), iterations=50, x0=cold_j.x,
                            y0=cold_j.y, s0=cold_j.rho_scale, **kw)
    assert_same_solution(warm_q, warm_qj)


def test_requires_single_batch_axis():
    P, q, A, l, u = to_t(make_fleet())
    with pytest.raises(ValueError, match="exactly one batch axis"):
        tqp.solve_qp_lanes(P[None], q[None], A[None], l[None], u[None], iterations=10)
    # solve_qp takes any leading axes
    sol = tqp.solve_qp(P[None], q[None], A[None], l[None], u[None], iterations=10)
    assert tuple(sol.x.shape) == (1, 5, 12)


def test_a_lane_that_is_not_convex_turns_nan_alone():
    """Failure as data: an indefinite P breaks its own lane's factorization;
    ``torch.linalg.cholesky`` would raise for the whole batch."""
    P, q, A, l, u = to_t(make_fleet(seed=3))
    good = tqp.solve_qp(P, q, A, l, u, iterations=50)
    P = P.clone()
    P[2] = -50.0 * torch.eye(12, dtype=P.dtype)
    for solve in (tqp.solve_qp, tqp.solve_qp_lanes):
        sol = solve(P, q, A, l, u, iterations=50)
        assert not bool(torch.isfinite(sol.x[2]).any()) and not bool(sol.converged[2])
        others = [0, 1, 3, 4]
        assert bool(torch.isfinite(sol.x[others]).all())
    sol = tqp.solve_qp(P, q, A, l, u, iterations=50)
    assert torch.equal(sol.x[[0, 1, 3, 4]], good.x[[0, 1, 3, 4]])


def test_float32_lanes_hold_the_reference_float32_limit():
    """float32 on both sides, 5e-3 absolute on x as ``tests/test_qp.py:269-270``
    holds the two float32 paths of the reference to each other."""
    args = make_fleet()
    f32 = tuple(a.astype(np.float32) for a in args)
    kw = dict(iterations=400, eps_abs=1e-4, eps_rel=1e-4)
    with jax.default_matmul_precision("highest"):
        sol_j = jqp.solve_qp_lanes(*to_j(f32), **kw)
    sol_t = tqp.solve_qp_lanes(*to_t(f32, torch.float32), **kw)
    assert sol_t.x.dtype == torch.float32
    np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), atol=5e-3)


def test_solve_dcm_mpc_per_lane_matches_the_reference():
    """``shared=False`` at horizon 8: every lane's own QP through ``solve_qp``."""
    N, B, dt = 8, 6, 0.1
    rng = np.random.default_rng(5)
    box = np.array([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]])
    a = dict(dcm0=rng.normal(0, 0.02, (B, 2)), com0=rng.normal(0, 0.01, (B, 2)),
             dcm_ref=np.zeros((N + 1, 2)), zmp_ref=np.zeros((N, 2)),
             poly_A=np.tile(box, (N, 1, 1)),
             poly_b=np.broadcast_to([0.1, 0.1, 0.06, 0.06], (N, 4)))
    keys = ("dcm0", "com0", "dcm_ref", "zmp_ref", "poly_A", "poly_b")
    pj = JLIPMParams(jnp.asarray(0.9), jnp.asarray(9.81))
    pt = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float64)
    ref = run_reference(jdcm.solve_dcm_mpc, pj, dt, *to_j(a[k] for k in keys), iterations=100)
    out = tdcm.solve_dcm_mpc(pt, dt, *to_t(a[k] for k in keys), iterations=100)
    for name in ("zmp", "dcm", "com"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(out.qp.converged.numpy(), np.asarray(ref.qp.converged))
    assert out.qp.refined is None
