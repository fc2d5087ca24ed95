"""The plain reference against the program, in float64 on the CPU at small
sizes, where the two are one computation in two evaluation orders: the
program's stage runs its plain loop (``backend="cuda"`` on CPU tensors)."""

import json

import numpy as np
import pytest
import torch

from portbench import generate
from portbench.harness import HERE
from portbench.reference import admm, fleet_tick, gait_plan

torch.set_num_threads(2)
CPU = torch.device("cpu")
PUSH = json.loads((HERE / "configs" / "push_recovery.json").read_text())
GAIT = json.loads((HERE / "configs" / "full_gait.json").read_text())
F64 = torch.float64


def test_transcription_and_factorization_are_the_programs():
    from blf_tpu_torch.models.lipm import LIPMParams
    from blf_tpu_torch.mpc.dcm import DCMWeights, build_dcm_qp
    from blf_tpu_torch.mpc.qp import factor_shared_qp

    pb = fleet_tick.prepare(dict(PUSH, horizon=8))
    rng = np.random.default_rng(0)
    dcm_ref, zmp_ref = rng.normal(0, 0.1, (9, 2)), rng.normal(0, 0.1, (8, 2))
    poly_A = np.broadcast_to(np.array([[1.0, 0], [-1, 0], [0, 1], [0, -1]]), (8, 4, 2))
    poly_b = rng.uniform(0.05, 0.1, (8, 4))
    P, q, A, b, is_eq = admm.transcribe(pb.a, PUSH["weights"], dcm_ref, zmp_ref, poly_A, poly_b)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64)
    params = LIPMParams(T(PUSH["com_height"]), T(PUSH["gravity"]))
    dcm0 = T(rng.normal(0, 0.02, (3, 2)))
    P2, q2, A2, l2, u2 = build_dcm_qp(params, PUSH["dt"], dcm0, T(dcm_ref), T(zmp_ref),
                                      T(poly_A), T(poly_b), DCMWeights(**PUSH["weights"]))
    assert np.allclose(P, P2.numpy(), atol=1e-14) and np.allclose(A, A2.numpy(), atol=1e-14)
    assert np.allclose(q, q2.numpy(), atol=1e-14)
    l, u = admm.lane_bounds(pb.a, dcm0, 8, T(b))
    assert torch.allclose(l, l2, atol=1e-14) and torch.allclose(u, u2, atol=1e-14)
    ours = admm.factor(P, A, is_eq, pb.settings)
    theirs = factor_shared_qp(P2, A2, torch.as_tensor(is_eq))
    for a, b_ in ((ours.P, theirs.P_s), (ours.A, theirs.A_s), (ours.D, theirs.D),
                  (ours.E, theirs.E), (ours.rho, theirs.base_rho)):
        assert np.allclose(a, b_.numpy(), rtol=1e-12, atol=1e-14)
    # the eigenbasis may differ inside a repeated eigenvalue; K(s)^-1 may not
    for s in (0.1, 1.0, 30.0):
        k1 = ours.W @ np.diag(1 / (1 + s * ours.d)) @ ours.W.T
        W, d = theirs.W.numpy(), theirs.d.numpy()
        assert np.allclose(k1, W @ np.diag(1 / (1 + s * d)) @ W.T, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("ensemble", [1, 2])
def test_fleet_tick_is_the_programs(ensemble):
    from blf_tpu_torch.parallel.sweep import init_fleet

    from portbench.paths.fleet_tick import program_step

    config = dict(PUSH, horizon=8, backend="cuda")
    lanes = 24
    problem = generate.push_problem(config, CPU, F64)
    push = generate.push_draws(lanes, ensemble, 0.004, 2 ** 31 + 3, CPU, F64)
    step = program_step(config, CPU)
    state = init_fleet(lanes, 8, problem.num_constraints, problem.dcm0, problem.com0,
                       device=CPU, dtype=F64)
    pb = fleet_tick.prepare(config)
    for _ in range(4):
        new, res = step(state, push, problem.dcm_ref, problem.zmp_ref, problem.poly_A,
                        problem.poly_b)
        ref = fleet_tick.tick(pb, fleet_tick.TickInput(
            state.dcm, state.com, state.warm_zmp, state.warm_y, state.offset_theta,
            state.offset_cov, state.warm_s, push))
        for got, want in ((res.consensus_zmp0, ref.zmp0), (new.dcm, ref.dcm), (new.com, ref.com),
                          (new.offset_theta, ref.theta), (new.offset_cov, ref.cov),
                          (new.warm_zmp, ref.warm_zmp), (new.warm_s, ref.warm_s)):
            # float64 on both sides; the spectral solve's error grows with
            # cond(P + sigma I + s A' rho A), some 1e8 here (sigma 1e-6), so
            # two float64 evaluation orders part by some 1e-9
            assert torch.allclose(got, want, rtol=1e-6, atol=1e-8)
        assert torch.equal(res.status.long(), ref.status.long())
        state = new


def test_gait_plan_is_the_programs():
    from blf_tpu_torch.models.lipm import LIPMParams
    from blf_tpu_torch.mpc.dcm import DCMWeights
    from blf_tpu_torch.planners.contacts import lower_contact_schedule
    from blf_tpu_torch.planners.gait import gait_references, plan_gait, support_polygons

    from portbench.paths.gait_plan import contact_lists

    lists = contact_lists(GAIT)
    pb = gait_plan.prepare(GAIT)
    params = LIPMParams(torch.tensor(GAIT["com_height"], dtype=F64),
                        torch.tensor(GAIT["gravity"], dtype=F64))
    schedule = lower_contact_schedule(lists, dt=GAIT["dt"], horizon=pb.N)
    A, b = support_polygons(schedule, GAIT["foot_half_length"], GAIT["foot_half_width"],
                            device=CPU, dtype=F64)
    rows = lambda A_, b_: sorted(map(tuple, np.round(np.concatenate([A_, b_[:, None]], 1), 9)))
    for k in range(pb.N):
        assert rows(A[k].numpy(), b[k].numpy()) == rows(pb.poly_A[k], pb.poly_b[k]), k
    zmp_ref, dcm_ref = gait_references(params, schedule, GAIT["dt"])
    assert np.allclose(zmp_ref.numpy(), pb.zmp_ref, atol=1e-14)
    assert np.allclose(dcm_ref.numpy(), pb.dcm_ref, atol=1e-12)
    dcm0 = generate.dcm0_pool(1, 6, 0.02, 11, CPU, F64)[0]
    plan, _ = plan_gait(params, lists, GAIT["dt"], dcm0, dcm0, half_length=GAIT["foot_half_length"],
                        half_width=GAIT["foot_half_width"], weights=DCMWeights(**GAIT["weights"]),
                        iterations=GAIT["iterations"], shared=True, backend="cuda",
                        check_every=GAIT["check_every"], **GAIT["qp"])
    ref = gait_plan.plan(pb, dcm0)
    assert torch.allclose(plan.dcm, ref.dcm, atol=1e-8)
    assert torch.allclose(plan.zmp, ref.zmp, atol=1e-8)
    assert torch.equal(plan.qp.converged, ref.converged) and bool(ref.converged.all())
