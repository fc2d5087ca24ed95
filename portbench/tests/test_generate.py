"""The frozen copies in ``portbench/`` against the program's own functions."""

import json

import numpy as np
import pytest
import torch

from portbench import generate, peaks
from portbench.reference import gait_plan
from portbench.harness import HERE

CPU = torch.device("cpu")
PUSH = json.loads((HERE / "configs" / "push_recovery.json").read_text())
GAIT = json.loads((HERE / "configs" / "full_gait.json").read_text())


@pytest.mark.parametrize("horizon", [8, 32])
def test_push_problem_is_the_programs(horizon):
    from blf_tpu_torch import problems

    config = dict(PUSH, horizon=horizon)
    ours = generate.push_problem(config, CPU)
    theirs = problems.stationary_push_recovery(16, horizon, seed=3, device=CPU,
                                               dtype=torch.float32)
    for field in ("dcm_ref", "zmp_ref", "poly_A", "poly_b", "dcm0", "com0"):
        assert torch.equal(getattr(ours, field), getattr(theirs, field)), field
    assert ours.num_constraints == theirs.num_constraints
    assert config["dt"] == theirs.dt
    assert config["com_height"] == pytest.approx(float(theirs.params.com_height))
    assert config["gravity"] == pytest.approx(float(theirs.params.gravity))
    assert theirs.disturbance.shape == (16, 1, 2)


def test_push_draws_are_seeded_per_member():
    seed = 2 ** 31 + 977
    a = generate.push_draws(50000, 2, 0.004, seed, CPU)
    assert a.shape == (50000, 2, 2) and a.dtype == torch.float32
    assert torch.equal(a, generate.push_draws(50000, 2, 0.004, seed, CPU))
    assert torch.equal(a[:, :1], generate.push_draws(50000, 1, 0.004, seed, CPU))
    assert torch.equal(a[:, 1:], generate.push_draws(50000, 1, 0.004, seed + 1, CPU))
    assert not torch.equal(a[:, 0], a[:, 1])
    assert float(a.std()) == pytest.approx(0.004, rel=0.02)
    assert abs(float(a.mean())) < 1e-4


def test_dcm0_pool_matches_the_programs_distribution():
    from blf_tpu_torch import problems

    pool = generate.dcm0_pool(3, 20000, 0.02, 2 ** 32 + 5, CPU)
    assert pool.shape == (3, 20000, 2)
    assert float(pool.abs().max()) <= 0.02
    assert float(pool.std()) == pytest.approx(0.04 / np.sqrt(12), rel=0.02)
    theirs = problems.gait_fleet(20000, seed=4, device=CPU, dtype=torch.float32).dcm0
    assert float(theirs.abs().max()) <= 0.02
    assert float(theirs.std()) == pytest.approx(float(pool.std()), rel=0.03)


def test_footsteps_are_the_programs_bit_for_bit():
    from blf_tpu_torch.planners.gait import footstep_plan, gait_horizon

    lists = footstep_plan(GAIT["num_steps"], GAIT["step_length"], GAIT["step_width"],
                          GAIT["step_duration"], GAIT["double_support"])
    ours = generate.footsteps(GAIT)
    assert sorted(ours) == sorted(lists)
    for foot, steps in ours.items():
        theirs = list(lists[foot])
        assert len(steps) == len(theirs)
        for st, c in zip(steps, theirs):
            assert st.position == tuple(float(v) for v in c.position)
            assert st.activation_time == c.activation_time
            assert st.deactivation_time == c.deactivation_time
            assert np.array_equal(c.rotation, np.eye(3))
    assert gait_plan.prepare(GAIT).N == gait_horizon(lists, GAIT["dt"]) == 96


@pytest.mark.parametrize("B,m,n,iters", [(98304, 192, 128, 25), (16384, 960, 384, 25),
                                         (1000, 96, 64, 50)])
def test_k1_counts_are_the_cost_models(B, m, n, iters):
    from blf_tpu_torch.utils import profiling

    cost = profiling.admm_stage_cost(B, m, n, iters, "delta")
    assert peaks.k1_flops(B, m, n, iters) == cost.useful_flops
    assert peaks.k1_bytes(B, m, n) == cost.bytes


def test_peaks_are_the_h100_sxm_data_sheet():
    from blf_tpu_torch.utils import profiling

    spec = profiling.spec_for_name("NVIDIA H100 80GB HBM3")
    assert (peaks.BF16_FLOPS, peaks.HBM_BYTES_PER_S) == (spec.peak_flops_bf16,
                                                         spec.hbm_bytes_per_s)
