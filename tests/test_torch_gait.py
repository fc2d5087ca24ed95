"""Port parity of the gait planner (``blf_tpu_torch/planners/gait.py``),
BASELINE config 3.

Same schedules and initial states in both packages; ``blf_tpu`` on JAX-CPU,
its Pallas kernel in interpret mode. Tolerances per test. The 10-step
acceptance plan of ``tests/test_gait.py::TestFullGait`` (2000 iterations) is
held on the port alone; parity with ``blf_tpu``'s whole plan uses a 2-step
gait, whose reference compiles in seconds.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models.lipm import LIPMParams as JLIPMParams
from blf_tpu.mpc import dcm as jdcm
from blf_tpu.planners import gait as jg
from blf_tpu.mpc.qp import factor_shared_qp as j_factor
from blf_tpu.planners.contacts import lower_contact_schedule as j_lower
from blf_tpu_torch.convert import factors_from_numpy, lipm_params_from_numpy
from blf_tpu_torch.mpc import dcm as tdcm
from blf_tpu_torch.mpc.dcm import solve_dcm_mpc
from blf_tpu_torch.ops.cuda import admm as stage
from blf_tpu_torch.planners import gait as tg
from blf_tpu_torch.planners.contacts import lower_contact_schedule
from blf_tpu_torch.problems import gait_fleet
from test_torch_wbc_loop import run_reference

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

DT = 0.1


def params(dtype):
    j = JLIPMParams(jnp.asarray(0.9, dtype), jnp.asarray(9.81, dtype))
    t = lipm_params_from_numpy(0.9, 9.81, device="cpu",
                               dtype={np.float64: torch.float64,
                                      np.float32: torch.float32}[dtype])
    return j, t


def both_schedules(num_steps, step_length=0.15):
    jl, tl = jg.footstep_plan(num_steps, step_length), tg.footstep_plan(num_steps, step_length)
    T = tg.gait_horizon(tl, DT)
    return jl, tl, T, j_lower(jl, dt=DT, horizon=T), lower_contact_schedule(tl, dt=DT, horizon=T)


def test_ten_step_schedule_polygons_and_references_equal_the_reference():
    """footstep_plan, the lowering, support_polygons (the batched hull over
    every knot at once) and gait_references: equal to 1e-12 in float64, the
    padding rows and the knot count included."""
    jl, tl, T, js, ts = both_schedules(10)
    assert T == 96 and tg.gait_horizon(tl, DT) == int(round(9.6 / DT))
    for foot in ("left", "right"):
        assert [(c.activation_time, c.deactivation_time, tuple(c.position)) for c in tl[foot]] \
            == [(c.activation_time, c.deactivation_time, tuple(c.position)) for c in jl[foot]]
    for field in ("times", "active", "position", "contact_index"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field), err_msg=field)
    jA, jb = jg.support_polygons(js)
    tA, tb = tg.support_polygons(ts, device="cpu", dtype=torch.float64)
    assert tuple(tA.shape) == (96, 8, 2) and tuple(tb.shape) == (96, 8)
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-12, rtol=0)
    pj, pt = params(np.float64)
    jz, jd = jg.gait_references(pj, js, DT)
    tz, td = tg.gait_references(pt, ts, DT)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-12, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-12, rtol=0)


def test_flight_knots_carry_the_previous_polygon():
    """A schedule with a gap in which no foot is active: the host-side
    fix-up copies the knot before's polygon and ZMP reference. The
    reference's own fix-up raises there (it writes into ``np.asarray`` of a
    JAX array, which is read-only: ``blf_tpu/planners/gait.py:144-147``), so
    the port's polygons are held to the reference's of the schedule without
    the gap, with the gap's knots replaced by knot 9's."""
    jl, tl, T, js, ts = both_schedules(2)
    jA, jb = jg.support_polygons(js)
    gap = slice(10, 13)
    for s in (js, ts):
        s.active[:, gap] = False
    with pytest.raises(ValueError, match="read-only"):
        jg.support_polygons(js)
    tA, tb = tg.support_polygons(ts, device="cpu", dtype=torch.float64)
    want_A, want_b = np.array(jA), np.array(jb)
    want_A[gap], want_b[gap] = want_A[9], want_b[9]
    np.testing.assert_allclose(tA.numpy(), want_A, atol=1e-12, rtol=0)
    np.testing.assert_allclose(tb.numpy(), want_b, atol=1e-12, rtol=0)
    pj, pt = params(np.float64)
    np.testing.assert_allclose(tg.gait_references(pt, ts, DT)[0].numpy(),
                               np.asarray(jg.gait_references(pj, js, DT)[0]), atol=1e-12)


def test_two_step_plan_matches_the_reference():
    """plan_gait in float64, the per-lane solver on both sides (the
    reference's "xla", the port's "torch"): zmp, dcm and com to 1e-6."""
    jl, tl, T, js, ts = both_schedules(2)
    pj, pt = params(np.float64)
    dcm0 = np.array([0.01, -0.02])
    jA, jb = jg.support_polygons(js)
    jz, jd = jg.gait_references(pj, js, DT)
    ref = run_reference(jdcm.solve_dcm_mpc, pj, DT, jnp.asarray(dcm0), jnp.asarray(dcm0),
                        jd, jz, jA, jb, iterations=400)
    plan, sched = tg.plan_gait(pt, tl, DT, torch.as_tensor(dcm0), torch.as_tensor(dcm0),
                               iterations=400)
    assert plan.zmp.shape == (T, 2) and plan.zmp.dtype == torch.float64
    assert sched.active.shape == (2, T)
    for name in ("zmp", "dcm", "com"):
        np.testing.assert_allclose(getattr(plan, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    assert bool(plan.qp.converged) == bool(ref.qp.converged)


def test_ten_step_gait_plan_passes_the_acceptance_checks():
    """TestFullGait.test_ten_step_gait_plan on the port: float64, 2000
    iterations, the whole 9.6 s gait as one QP."""
    lists = tg.footstep_plan(num_steps=10, step_length=0.15)
    _, pt = params(np.float64)
    dcm0 = torch.zeros(2, dtype=torch.float64)
    plan, schedule = tg.plan_gait(pt, lists, DT, dcm0, dcm0, iterations=2000)
    assert bool(plan.qp.converged), (float(plan.qp.primal_residual),
                                     float(plan.qp.dual_residual))
    assert plan.zmp.shape[0] == 96
    poly_A, poly_b = tg.support_polygons(schedule, device="cpu", dtype=torch.float64)
    margins = torch.einsum("kfa,ka->kf", poly_A, plan.zmp) - poly_b
    assert float(margins.max()) <= 1e-5, float(margins.max())
    np.testing.assert_allclose(plan.dcm[-1].numpy(), [0.75, 0.0], atol=0.02)
    com = plan.com.numpy()
    assert com[-1, 0] > 0.6 and np.abs(com[:, 1]).max() < 0.12 and np.isfinite(com).all()


def test_gait_fleet_on_the_kernel_backend_matches_pallas_f32():
    """The config-3 fleet's shared QP at (960, 384): 256 lanes, float32, 100
    iterations, ``solve_dcm_mpc(shared=True, backend="cuda")`` on CPU tensors
    (the stage's plain version, 4 stages) against the reference's
    ``"pallas_f32"`` in interpret mode on the same inputs. Each side factors
    its own operator (their eigenbases differ inside degenerate eigenspaces),
    so the plans agree to the float32 solver's precision, not bit for bit:
    zmp within 2e-5 m (measured 3e-6), the same converged count (all)."""
    fleet = gait_fleet(256, device="cpu", dtype=torch.float32)
    schedule = lower_contact_schedule(fleet.lists, dt=fleet.dt,
                                      horizon=tg.gait_horizon(fleet.lists, fleet.dt))
    poly_A, poly_b = tg.support_polygons(schedule, device="cpu", dtype=torch.float32)
    zmp_ref, dcm_ref = tg.gait_references(fleet.params, schedule, fleet.dt)
    inputs = (fleet.dcm0, fleet.com0, dcm_ref, zmp_ref, poly_A, poly_b)
    stage.reset_counts()
    ours = solve_dcm_mpc(fleet.params, fleet.dt, *inputs, iterations=100, shared=True,
                         backend="cuda")
    assert stage.reference_count() == 4 and stage.l2_launch_count() == 0
    assert stage.streams_operator(*ours.qp.y.shape[-1:], ours.qp.x.shape[-1])
    pj, _ = params(np.float32)
    theirs = jdcm.solve_dcm_mpc(pj, fleet.dt, *(jnp.asarray(t.numpy()) for t in inputs),
                                iterations=100, shared=True, backend="pallas_f32")
    assert theirs.zmp.dtype == jnp.float32
    assert int(ours.qp.converged.sum()) == int(theirs.qp.converged.sum()) == 256
    np.testing.assert_allclose(ours.zmp.numpy(), np.asarray(theirs.zmp), atol=2e-5, rtol=0)


@pytest.mark.parametrize("backend,jax_backend", [("cuda_delta", "pallas"),
                                                 ("cuda_split", "pallas_split")])
def test_two_step_gait_fleet_in_the_reduced_modes_matches_pallas(backend, jax_backend):
    """The 2-step gait's shared QP at (320, 128), past what the resident
    tensor-core kernel holds (on the card the streaming one runs it): 256
    lanes, float32, 100 iterations, ``solve_dcm_mpc(shared=True,
    backend=...)`` on CPU tensors (the stage's plain version, 4 stages)
    against the reference's ``"pallas"`` / ``"pallas_split"`` in interpret
    mode, called eagerly (jitted on the CPU, its delta MPC is not its eager
    self: ROADMAP.md section 3).

    The reference factors the float32 operator in float32 and there leaves
    every lane's dual residual near 3.8e-4, above eps: it converges none of
    the 256 in either mode (so does the reference under ``jax.disable_jit``).
    Handed those factors, the port does the same: the same converged count
    and zmp within 1e-5 m (measured 2.7e-6 delta, 1.0e-6 split). With its own
    factorization (float64, cast: ``factor_shared_qp``) the port converges
    every lane, and its plan stays within 5e-5 m of the reference's (measured
    1.4e-5 in both modes)."""
    fleet = gait_fleet(256, num_steps=2, device="cpu", dtype=torch.float32)
    schedule = lower_contact_schedule(fleet.lists, dt=fleet.dt,
                                      horizon=tg.gait_horizon(fleet.lists, fleet.dt))
    poly_A, poly_b = tg.support_polygons(schedule, device="cpu", dtype=torch.float32)
    zmp_ref, dcm_ref = tg.gait_references(fleet.params, schedule, fleet.dt)
    inputs = (fleet.dcm0, fleet.com0, dcm_ref, zmp_ref, poly_A, poly_b)
    pj, _ = params(np.float32)
    seen = []

    def record(*args, **kw):
        seen.append(j_factor(*args, **kw))
        return seen[-1]

    with mock.patch.object(jdcm, "factor_shared_qp", record):
        theirs = jdcm.solve_dcm_mpc(pj, fleet.dt, *(jnp.asarray(t.numpy()) for t in inputs),
                                    iterations=100, shared=True, backend=jax_backend)
    assert theirs.zmp.dtype == jnp.float32 and len(seen) == 1
    their_factors = factors_from_numpy(seen[0], device="cpu", dtype=torch.float32)

    stage.reset_counts()
    ours = solve_dcm_mpc(fleet.params, fleet.dt, *inputs, iterations=100, shared=True,
                         backend=backend)
    assert stage.tc_reference_count() == 4 and stage.reference_count() == 0
    assert stage.tc_launch_count() == stage.tc_l2_launch_count() == 0
    assert (ours.qp.y.shape[-1], ours.qp.x.shape[-1]) == (320, 128)
    assert stage.tc_streams_operator(320, 128)
    assert int(ours.qp.converged.sum()) == 256
    np.testing.assert_allclose(ours.zmp.numpy(), np.asarray(theirs.zmp), atol=5e-5, rtol=0)

    with mock.patch.object(tdcm, "factor_shared_qp", lambda *a, **kw: their_factors):
        alike = solve_dcm_mpc(fleet.params, fleet.dt, *inputs, iterations=100, shared=True,
                              backend=backend)
    assert int(alike.qp.converged.sum()) == int(np.asarray(theirs.qp.converged).sum())
    np.testing.assert_allclose(alike.zmp.numpy(), np.asarray(theirs.zmp), atol=1e-5, rtol=0)
