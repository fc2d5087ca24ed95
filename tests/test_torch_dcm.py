"""Port parity of the DCM-MPC transcription and its shared-operator solve,
and of the problem instances both sides are fed with.

Inputs are numpy arrays made from a seed; the JAX functions of ``blf_tpu`` and
their counterparts in ``blf_tpu_torch`` (``device="cpu"``) get the same ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import F32_LANE, tol

from __graft_entry__ import _example_problem
from blf_tpu.models import lipm as jlipm
from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.mpc import dcm as jdcm
from blf_tpu_torch.convert import lipm_params_from_numpy
from blf_tpu_torch.models import lipm as tlipm
from blf_tpu_torch.mpc import dcm as tdcm
from blf_tpu_torch.problems import example_problem, stationary_push_recovery
from test_torch_wbc_loop import run_reference

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

NP_DTYPE = np.float32 if F32_LANE else np.float64
T_DTYPE = torch.float32 if F32_LANE else torch.float64
J_DTYPE = jnp.dtype(NP_DTYPE)
DT = 0.1


def to_t(a):
    return torch.as_tensor(np.array(a, NP_DTYPE), dtype=T_DTYPE, device="cpu")


def stationary_numpy(N, B, seed=0):
    """The stationary push-recovery inputs (as the fleet bench builds them)."""
    rng = np.random.default_rng(seed)
    box = np.array([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]])
    return dict(
        dcm0=rng.normal(0, 0.02, (B, 2)), com0=rng.normal(0, 0.01, (B, 2)),
        dcm_ref=np.zeros((N + 1, 2)), zmp_ref=np.zeros((N, 2)),
        poly_A=np.tile(box, (N, 1, 1)),
        poly_b=np.broadcast_to([0.1, 0.1, 0.06, 0.06], (N, 4)),
    )


def walking_numpy(N, B):
    """The four-step walking reference of the JAX package's entry point."""
    _, _, dcm0, dcm_ref, zmp_ref, poly_A, poly_b = _example_problem(B, N, J_DTYPE)
    return dict(dcm0=np.asarray(dcm0), com0=np.asarray(dcm0),
                dcm_ref=np.asarray(dcm_ref), zmp_ref=np.asarray(zmp_ref),
                poly_A=np.asarray(poly_A), poly_b=np.asarray(poly_b))


def params_pair():
    return (JLIPMParams(jnp.asarray(0.9, J_DTYPE), jnp.asarray(9.81, J_DTYPE)),
            lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=T_DTYPE))


KEYS = ("dcm_ref", "zmp_ref", "poly_A", "poly_b")


@pytest.mark.parametrize("make,N", [(stationary_numpy, 8), (walking_numpy, 16)])
def test_build_dcm_qp_entrywise(make, N):
    a = make(N, 5)
    pj, pt = params_pair()
    ref = run_reference(jdcm.build_dcm_qp, pj, DT, jnp.asarray(a["dcm0"], J_DTYPE),
                        *(jnp.asarray(a[k], J_DTYPE) for k in KEYS))
    out = tdcm.build_dcm_qp(pt, DT, to_t(a["dcm0"]), *(to_t(a[k]) for k in KEYS))
    for name, o, r in zip(("P", "q", "A", "l", "u"), out, ref):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape, name
        # the infinities sit in the same places; the rest agrees to rounding
        # of e^{w dt} (one exp on each side)
        np.testing.assert_array_equal(np.isinf(o.numpy()), np.isinf(r), err_msg=name)
        np.testing.assert_allclose(o.numpy(), r, atol=tol(1e-14, 1e-6), rtol=0,
                                   err_msg=name)
    assert np.isneginf(out[3].numpy()[:, 2 * N:]).all()
    assert out[0].dim() == 2 and out[2].dim() == 2     # one shared (P, A)


@pytest.mark.parametrize("make,N,iters", [(stationary_numpy, 16, 100),
                                          (walking_numpy, 8, 100)])
def test_solve_dcm_mpc_shared_plan(make, N, iters):
    a = make(N, 24)
    pj, pt = params_pair()
    kw = dict(iterations=iters, shared=True, polish_iters=25)
    ref = run_reference(
        jdcm.solve_dcm_mpc, pj, DT, jnp.asarray(a["dcm0"], J_DTYPE),
        jnp.asarray(a["com0"], J_DTYPE), *(jnp.asarray(a[k], J_DTYPE) for k in KEYS), **kw)
    out = tdcm.solve_dcm_mpc(pt, DT, to_t(a["dcm0"]), to_t(a["com0"]),
                             *(to_t(a[k]) for k in KEYS), **kw)
    atol = tol(1e-7, 5e-4)
    for name in ("zmp", "dcm", "com"):
        o, r = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, atol=atol, rtol=0, err_msg=name)
    assert tuple(out.zmp.shape) == (24, N, 2) and tuple(out.com.shape) == (24, N + 1, 2)
    if not F32_LANE:
        np.testing.assert_array_equal(out.qp.converged.numpy(),
                                      np.asarray(ref.qp.converged))


def test_warm_started_resolve_matches():
    """Second solve seeded by the first one's plan, duals and penalty."""
    N = 8
    a = stationary_numpy(N, 16, seed=3)
    pj, pt = params_pair()
    jargs = [jnp.asarray(a[k], J_DTYPE) for k in ("dcm0", "com0") + KEYS]
    targs = [to_t(a[k]) for k in ("dcm0", "com0") + KEYS]
    j1 = run_reference(jdcm.solve_dcm_mpc, pj, DT, *jargs, iterations=100, shared=True)
    j2 = run_reference(jdcm.solve_dcm_mpc, pj, DT, *jargs, iterations=50, shared=True,
                       warm_start=j1.zmp, warm_start_dual=j1.qp.y, s0=j1.qp.rho_scale)
    t2 = tdcm.solve_dcm_mpc(pt, DT, *targs, iterations=50, shared=True,
                            warm_start=to_t(j1.zmp), warm_start_dual=to_t(j1.qp.y),
                            s0=to_t(j1.qp.rho_scale), backend="cuda")
    np.testing.assert_allclose(t2.zmp.numpy(), np.asarray(j2.zmp),
                               atol=tol(1e-7, 5e-4), rtol=0)


def test_what_is_not_ported_raises():
    a = stationary_numpy(8, 4)
    _, pt = params_pair()
    args = [to_t(a[k]) for k in ("dcm0", "com0") + KEYS]
    # the per-lane path is ported (tests/test_torch_qp_lanes.py holds it to
    # the reference), and so are the reduced-precision kernel forms
    # (tests/test_torch_admm_stage_tc.py), which take float32 only
    assert tdcm.solve_dcm_mpc(pt, DT, *args, shared=False, iterations=25).zmp.shape == (4, 8, 2)
    with pytest.raises(TypeError, match="float32 only"):
        tdcm.solve_dcm_mpc(pt, DT, *(a.double() for a in args), shared=True,
                           backend="cuda_split")
    args[4] = args[4][None].expand(4, -1, -1, -1)      # per-lane polygons
    with pytest.raises(ValueError, match="unbatched"):
        tdcm.solve_dcm_mpc(pt, DT, *args, shared=True)


def test_example_problem_matches_the_jax_entry_point():
    ref = _example_problem(12, 16, J_DTYPE)
    out = example_problem(12, 16, seed=0, device="cpu", dtype=T_DTYPE)
    assert out[1] == ref[1] == DT
    np.testing.assert_allclose(float(out[0].com_height), float(ref[0].com_height))
    for o, r in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=tol(1e-14, 1e-6))


def test_stationary_push_recovery_is_the_bench_workload(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pr = stationary_push_recovery(64, 32, seed=0, device="cpu", dtype=torch.float32)
    dist = np.random.default_rng(0).normal(0, 0.004, (64, 1, 2)).astype(np.float32)
    np.testing.assert_array_equal(pr.disturbance.numpy(), dist)
    assert pr.num_constraints == 192 and pr.dt == DT
    assert tuple(pr.poly_A.shape) == (32, 4, 2) and tuple(pr.poly_b.shape) == (32, 4)
    np.testing.assert_allclose(pr.poly_b[5].numpy(), [0.1, 0.1, 0.06, 0.06])
    np.testing.assert_allclose(pr.dcm0.numpy(), [0.01, -0.01])
    assert not pr.dcm_ref.any() and not pr.zmp_ref.any()
    with pytest.raises(RuntimeError, match="CUDA"):
        stationary_push_recovery(4, 8)          # device=None means the GPU


def test_dcm_reference_trajectory_matches():
    """The piecewise-constant ZMP reference of a footstep sequence and its
    DCM by the backward recursion, ending on the last foothold."""
    footholds = np.array([[0.0, -0.1], [0.2, 0.1], [0.4, -0.1]])
    durations = np.array([0.8, 0.7, 0.5])
    pj, pt = params_pair()
    jz, jd = jlipm.dcm_reference_trajectory(pj, jnp.asarray(footholds, J_DTYPE), durations, DT)
    tz, td = tlipm.dcm_reference_trajectory(pt, to_t(footholds), durations, DT)
    assert tuple(tz.shape) == (20, 2) and tuple(td.shape) == (21, 2)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=0, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=tol(1e-14, 1e-6), rtol=0)
    np.testing.assert_allclose(td[-1].numpy(), footholds[-1], atol=0)


def test_config1_step_plan_matches_the_reference():
    """BASELINE config 1, ``examples/01_dcm_step_plan.py``'s plan: stand on
    (0, -0.1), step to (0.2, 0.1), N = 15 at dt = 0.1, one unbatched
    ``solve_dcm_mpc`` of 400 iterations (the per-lane solver) in both
    packages on the same inputs: the plan agrees to 1e-6 (float64), and the
    port's passes ``tests/test_dcm_mpc.py::TestDCMMPC``'s checks: converged,
    every ZMP inside its polygon (1e-6), the terminal DCM on the last foothold
    (0.02), the CoM inside the footprint band."""
    footholds = np.array([[0.0, -0.1], [0.2, 0.1]])
    pj, pt = params_pair()
    zmp_ref, dcm_ref = tlipm.dcm_reference_trajectory(pt, to_t(footholds), [0.8, 0.7], DT)
    box = np.array([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]])
    z = zmp_ref.numpy()
    poly_A = np.tile(box, (15, 1, 1))
    poly_b = np.stack([z[:, 0] + 0.07, -(z[:, 0] - 0.07), z[:, 1] + 0.04, -(z[:, 1] - 0.04)], -1)
    dcm0 = np.array([0.0, -0.05])
    inputs = (dcm0, dcm0, dcm_ref.numpy(), z, poly_A, poly_b)
    ref = run_reference(jdcm.solve_dcm_mpc, pj, DT, *(jnp.asarray(a, J_DTYPE) for a in inputs),
                        iterations=400)
    plan = tdcm.solve_dcm_mpc(pt, DT, *(to_t(a) for a in inputs), iterations=400)
    for name in ("zmp", "dcm", "com"):
        np.testing.assert_allclose(getattr(plan, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=tol(1e-6, 5e-4), rtol=0, err_msg=name)
    assert bool(plan.qp.converged) and bool(ref.qp.converged)
    margins = np.einsum("kfa,ka->kf", poly_A, plan.zmp.numpy())
    assert np.all(margins <= poly_b + 1e-6)
    np.testing.assert_allclose(plan.dcm[-1].numpy(), [0.2, 0.1], atol=0.02)
    com = plan.com.numpy()
    assert com[:, 0].max() <= 0.28 and com[:, 0].min() >= -0.08 and np.isfinite(com).all()
