"""The port's speed-of-light accounting (``blf_tpu_torch/utils/profiling.py``)
against ``blf_tpu.utils.profiling``, on the CPU.

* (a) ``tests/test_profiling.py``'s cases on the port: chip specs and the
  longest match, the roofline, ``cost_analysis`` of ``x @ x``, ``measure``,
  ``sol_report`` on a matrix product and on the factored QP solve, ``trace``
  (its name in ``torch.profiler``'s events).
* (b) The same numbers from both packages on equal inputs: ``roofline_seconds``
  and ``sol_score`` on one set of ceilings, the ADMM stage's useful FLOPs in
  every mode, and both ``cost_analysis`` on ``x @ x``.
* (c) Every kernel's bound on the H100 SXM's ceilings, pinned to the digits
  ``PERF.md`` section 6 records (printed by ``chip_smoke.py``'s ``kernels``
  phase).
* (d) ``measure_chained`` times chains of ``ticks`` applications of ``step``,
  each taking the previous output; ``sol_rows`` runs on CPU tensors at a
  small size, with the kernels' plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.utils import profiling as jprof
from blf_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)

SPEC = tprof.ChipSpec("test", peak_flops_bf16=2e12, peak_flops_f32=1e12, hbm_bytes_per_s=1e11)
SXM = tprof.CHIP_SPECS["h100 80gb hbm3"]


# ---------------------------------------------------------------------------
# (a) the reference's cases
# ---------------------------------------------------------------------------

def test_the_cpu_is_the_host_entry():
    assert tprof.detect_chip("cpu").name == "host CPU"
    assert tprof.detect_chip(torch.device("cpu")) == tprof.CHIP_SPECS["cpu"]


def test_no_device_means_the_gpu_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.detect_chip()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.sol_score(1.0, flops=1.0)


@pytest.mark.parametrize("name, spec", [
    ("NVIDIA H100 80GB HBM3", "H100 SXM"),
    ("nvidia h100 80gb hbm3", "H100 SXM"),   # case aside
    ("NVIDIA H100 PCIe", "H100 PCIe"),       # not shadowed by the SXM's key
    ("cpu", "host CPU"),
])
def test_longest_substring_match_wins(name, spec):
    assert tprof.spec_for_name(name).name == spec


def test_the_h100_ceilings():
    pcie = tprof.spec_for_name("NVIDIA H100 PCIe")
    assert (SXM.peak_flops_bf16, SXM.peak_flops_f32, SXM.hbm_bytes_per_s) == (989e12, 67e12,
                                                                              3.35e12)
    assert (pcie.peak_flops_bf16, pcie.peak_flops_f32, pcie.hbm_bytes_per_s) == (756e12, 51e12,
                                                                                 2.0e12)
    cpu, ref_cpu = tprof.CHIP_SPECS["cpu"], jprof.CHIP_SPECS["cpu"]
    assert (cpu.peak_flops_bf16, cpu.peak_flops_f32, cpu.hbm_bytes_per_s) == (
        ref_cpu.peak_flops_bf16, ref_cpu.peak_flops_f32, ref_cpu.hbm_bytes_per_s)


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 NVL", "NVIDIA H100"])
def test_an_unknown_card_is_not_scored_as_another(name):
    # an H100 variant not listed by its own name has other ceilings than the SXM's
    with pytest.raises(LookupError, match="no ChipSpec"):
        tprof.spec_for_name(name)


def test_bf16_peak_is_at_least_f32():
    for spec in tprof.CHIP_SPECS.values():
        assert spec.peak_flops("bf16") >= spec.peak_flops("f32")


@pytest.mark.parametrize("flops, nbytes, dtype, seconds", [
    (1e12, 1e9, "f32", 1.0),     # compute bound: 1e12 FLOP at 1e12 FLOP/s
    (1e9, 1e11, "f32", 1.0),     # memory bound: 1e11 B at 1e11 B/s
    (2e12, 0.0, "bf16", 1.0),    # the dtype picks the ceiling
    (2e12, 0.0, "f32", 2.0),
])
def test_roofline(flops, nbytes, dtype, seconds):
    assert tprof.roofline_seconds(flops, nbytes, SPEC, dtype=dtype) == pytest.approx(seconds)


def test_matmul_flops_counted():
    n = 256
    a = torch.ones((n, n))
    cost = tprof.cost_analysis(lambda x: x @ x, a)
    assert cost["flops"] == 2 * n ** 3
    assert cost["bytes"] == 3 * n * n * 4       # two operands read, the product written


def test_views_move_no_bytes_and_elementwise_work_counts_no_flops():
    a = torch.ones((64, 64))
    cost = tprof.cost_analysis(lambda x: x.reshape(-1)[:100].unsqueeze(0) * 2.0, a)
    assert cost["flops"] == 0.0
    assert cost["bytes"] == 2 * 100 * 4        # the product's input view and output
    # a transpose is a view, but flattening it copies: read once, written once
    cost = tprof.cost_analysis(lambda x: x.T.reshape(-1), a)
    assert cost["bytes"] == 2 * 64 * 64 * 4


def test_measure_returns_positive_seconds():
    x = torch.ones((128, 128))
    t = tprof.measure(lambda x: (x @ x).sum(), x, warmup=1, repeats=3, inner=2)
    assert 0.0 < t < 10.0
    assert 0.0 < tprof.measure(lambda x: x @ x, x, warmup=1, repeats=3, reduce="min") < 10.0


def test_sol_report_fields_consistent():
    x = torch.ones((256, 256))
    r = tprof.sol_report(lambda x: x @ x, x, label="mm", warmup=1, repeats=3)
    assert r["label"] == "mm" and r["chip"] == "host CPU"
    assert r["bound"] in ("compute", "memory")
    assert r["time_s"] > 0.0
    assert r["sol_frac"] == pytest.approx(r["sol_time_s"] / r["time_s"])
    assert r["achieved_tflops"] == pytest.approx(r["flops"] / r["time_s"] / 1e12)


def test_report_on_the_factored_qp_program():
    """The accounting works on the port's own hot path (``backend="torch"``)."""
    from blf_tpu_torch.mpc.qp import factor_shared_qp, solve_qp_factored

    n, m, batch = 8, 12, 32
    rng = np.random.default_rng(0)
    L = torch.as_tensor(rng.normal(size=(n, n)))
    P = L @ L.T + 0.5 * torch.eye(n, dtype=torch.float64)
    A = torch.as_tensor(rng.normal(size=(m, n)))
    is_eq = torch.arange(m) < 4
    factors = factor_shared_qp(P, A, is_eq)
    q = torch.as_tensor(rng.normal(size=(batch, n)))
    l = torch.full((batch, m), -1.0, dtype=torch.float64)
    l[:, :4] = 0.0
    u = torch.ones((batch, m), dtype=torch.float64)
    u[:, :4] = 0.0
    solve = lambda q, l, u: solve_qp_factored(factors, q, l, u, iterations=20)
    r = tprof.sol_report(solve, q, l, u, label="qp", warmup=1, repeats=2)
    assert r["flops"] > 0.0 and r["bytes"] > 0.0
    assert r["time_s"] > 0.0


def test_trace_wraps_computation_and_names_the_region():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.trace("test-region"):
            with tprof.trace("inner/qp-iteration"):
                y = torch.ones(4) * 2
    assert float(y.sum()) == 8.0
    names = {e.name for e in prof.events()}
    assert {"test-region", "inner/qp-iteration"} <= names


# ---------------------------------------------------------------------------
# (b) parity with blf_tpu.utils.profiling on equal inputs
# ---------------------------------------------------------------------------

REF_SPEC = jprof.ChipSpec("test", peak_flops_bf16=2e12, peak_flops_f32=1e12,
                          hbm_bytes_per_s=1e11)
WORK = [(1e12, 1e9, "f32"), (1e9, 1e11, "f32"), (3e12, 4e10, "bf16"), (5e11, 5e10, "f32"),
        (0.0, 0.0, "f32")]


@pytest.mark.parametrize("flops, nbytes, dtype", WORK)
def test_roofline_and_score_match_the_reference(flops, nbytes, dtype):
    assert tprof.roofline_seconds(flops, nbytes, SPEC, dtype) == pytest.approx(
        jprof.roofline_seconds(flops, nbytes, REF_SPEC, dtype), rel=1e-12, abs=0.0)
    ours = tprof.sol_score(0.37, label="x", dtype=dtype, spec=SPEC, flops=flops, nbytes=nbytes)
    ref = jprof.sol_score(0.37, label="x", dtype=dtype, spec=REF_SPEC, flops=flops,
                          nbytes=nbytes)
    assert ours.keys() == ref.keys()
    for key, value in ref.items():
        if isinstance(value, str):
            assert ours[key] == value, key
        else:
            assert ours[key] == pytest.approx(value, rel=1e-12, abs=0.0), key


@pytest.mark.parametrize("mode", ["f32", "delta", "split"])
@pytest.mark.parametrize("B, m, n, iters", [(98304, 192, 128, 25), (4096, 960, 384, 25),
                                            (7, 48, 32, 3)])
def test_admm_stage_useful_flops_match_the_reference(B, m, n, iters, mode):
    assert (tprof.admm_stage_cost(B, m, n, iters, mode).useful_flops
            == jprof.admm_stage_cost(B, m, n, iters, mode).useful_flops)


def test_both_cost_analyses_count_a_matmul_alike():
    n = 256
    ours = tprof.cost_analysis(lambda x: x @ x, torch.ones((n, n)))
    ref = jprof.cost_analysis(lambda x: x @ x, jnp.ones((n, n), jnp.float32))
    assert ours["flops"] == pytest.approx(ref["flops"], rel=0.2)
    assert ref["flops"] == pytest.approx(2 * n ** 3, rel=0.2)


def test_the_foot_rollout_counts_376_operations_where_the_reference_counts_360():
    ours = tprof.foot_rollout_cost(1000, 10)
    assert ours.useful_flops == ours.fma_flops == 376 * 1000 * 10
    assert jprof.foot_rollout_cost(1000, 10).useful_flops == 360 * 1000 * 10


# ---------------------------------------------------------------------------
# (c) the bounds PERF.md section 6 records, on the H100 SXM's ceilings
# ---------------------------------------------------------------------------

BOUNDS = [
    # (cost, milliseconds recorded, what bounds it)
    ("K1 f32", tprof.admm_stage_cost(98304, 192, 128, 25, "f32"), 3.61, "fma"),
    ("K1 f32 stack", tprof.admm_stage_cost(4096, 48, 32, 25, "f32"), 0.0094, "fma"),
    ("K1-L gait10", tprof.admm_stage_cost(4096, 960, 384, 25, "f32"), 2.25, "fma"),
    ("K1-L gait6", tprof.admm_stage_cost(4096, 640, 256, 25, "f32"), 1.00, "fma"),
    ("K1-L tick_h40", tprof.admm_stage_cost(4096, 240, 160, 25, "f32"), 0.235, "fma"),
    ("K1 delta", tprof.admm_stage_cost(98304, 192, 128, 25, "delta"), 0.498, "tensor"),
    ("K1 split", tprof.admm_stage_cost(98304, 192, 128, 25, "split"), 0.733, "tensor"),
    ("K1-TC-L delta", tprof.admm_stage_cost(4096, 960, 384, 25, "delta"), 0.311, "tensor"),
    ("K1-TC-L split", tprof.admm_stage_cost(4096, 960, 384, 25, "split"), 0.458, "tensor"),
    ("K2 stack", tprof.admm_lane_cost(4096, 86, 64, 150), 0.277, "fma"),
    ("K2 wbc", tprof.admm_lane_cost(4096, 86, 64, 25), 0.0497, "memory"),
    ("K3 n64", tprof.cholesky_inverse_cost(4096, 64), 0.0401, "memory"),
    ("K3 n29", tprof.cholesky_inverse_cost(4096, 29), 0.0082, "memory"),
    ("K4 n6", tprof.cholesky_solve_cost(4096, 6), 0.000235, "memory"),
    ("K5 foot", tprof.foot_rollout_cost(65536, 1000), 0.368, "fma"),
    ("K5 segment", tprof.foot_rollout_cost(65536, 10), 0.00368, "fma"),
]


@pytest.mark.parametrize("cost, ms, unit", [b[1:] for b in BOUNDS], ids=[b[0] for b in BOUNDS])
def test_each_kernel_bound_is_the_recorded_one(cost, ms, unit):
    assert 1e3 * cost.sol_seconds(SXM) == pytest.approx(ms, rel=5e-3)
    times = cost.unit_seconds(SXM)
    assert max(times, key=times.get) == unit
    t = 2 * cost.sol_seconds(SXM)
    r = tprof.sol_score(t, spec=SXM, kernel_cost=cost)
    assert r["bound"] == unit and r["sol_frac"] == pytest.approx(0.5)
    assert r["tensor_core_util"] == pytest.approx(cost.useful_flops / t / 989e12)


def test_the_tensor_core_stage_counts_its_passes_and_elementwise_work():
    B, m, n, iters = 98304, 192, 128, 25
    for mode, passes in (("split", 150), ("delta", 102)):
        cost = tprof.admm_stage_cost(B, m, n, iters, mode)
        assert cost.tensor_flops == passes * 2 * m * n * B
    # PERF.md section 6: the elementwise bound 0.20 / 0.22 ms, the bytes 0.135 ms
    split = tprof.admm_stage_cost(B, m, n, iters, "split").unit_seconds(SXM)
    delta = tprof.admm_stage_cost(B, m, n, iters, "delta").unit_seconds(SXM)
    assert 1e3 * delta["fma"] == pytest.approx(0.20, rel=0.05)
    assert 1e3 * split["fma"] == pytest.approx(0.22, rel=0.05)
    assert 1e3 * split["memory"] == pytest.approx(0.135, rel=5e-3)


# The bounds as chip_smoke.py computed them before the cost models existed,
# written out: (unit, ms) of each unit at the H100 SXM data sheet's peaks.
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12


def stage_bytes(B, m, n):
    return 4 * (B * ((3 * m + 2 * n + 1) + (m + n)) + m * n + m + n)


def old_f32_stage(B, m, n, iters):
    return {"fma": 1e3 * iters * 2 * (2 * m * n) * B / PEAK_F32,
            "memory": 1e3 * stage_bytes(B, m, n) / PEAK_BYTES}


def old_tc_stage(B, m, n, iters, matmul):
    passes = 2 * (3 * iters if matmul == "split" else 3 + 2 * (iters - 1))
    first, later = 27 * m + 6 * n, (27 * m + 6 * n if matmul == "split" else 25 * m + 4 * n)
    ops = B * (first + (iters - 1) * later + 5 * n)
    return {"tensor": 1e3 * passes * 2 * m * n * B / PEAK_BF16, "fma": 1e3 * ops / PEAK_F32,
            "memory": 1e3 * stage_bytes(B, m, n) / PEAK_BYTES}


def old_lane(B, m, n, iters):
    return {"fma": 1e3 * iters * 2 * (2 * m * n + n * n) * B / PEAK_F32,
            "memory": 1e3 * 4 * B * (m * n + n * n + 5 * m + 2 * n) / PEAK_BYTES}


def old_inverse(B, n):
    return {"fma": 1e3 * B * n ** 3 / PEAK_F32, "memory": 1e3 * 4 * B * 2 * n * n / PEAK_BYTES}


def old_solve(B, n):
    return {"fma": 1e3 * B * (n ** 3 / 3 + 2 * n * n) / PEAK_F32,
            "memory": 1e3 * 4 * B * (n * n + 2 * n) / PEAK_BYTES}


def old_foot(B, steps, operand_floats):
    return {"fma": 1e3 * B * steps * 376 / PEAK_F32,
            "memory": 1e3 * 4 * (2 * 18 * B + operand_floats) / PEAK_BYTES}


OLD_AND_NEW = [
    *[(f"K1 f32 {s}", old_f32_stage(*s), tprof.admm_stage_cost(*s, "f32"))
      for s in [(98304, 192, 128, 25), (4096, 48, 32, 25), (98304, 96, 64, 50),
                (4096, 960, 384, 25), (4096, 240, 160, 25), (1, 97, 33, 1)]],
    *[(f"K1 {mode} {s}", old_tc_stage(*s, mode), tprof.admm_stage_cost(*s, mode))
      for mode in ("delta", "split")
      for s in [(98304, 192, 128, 25), (98304, 96, 64, 50), (4096, 48, 32, 25),
                (4096, 960, 384, 25), (1, 100, 150, 1)]],
    *[(f"K2 {s}", old_lane(*s), tprof.admm_lane_cost(*s))
      for s in [(4096, 86, 64, 25), (4096, 86, 64, 150), (3, 7, 5, 1)]],
    *[(f"K3 {s}", old_inverse(*s), tprof.cholesky_inverse_cost(*s))
      for s in [(4096, 64), (4096, 29), (1, 3)]],
    *[(f"K4 {s}", old_solve(*s), tprof.cholesky_solve_cost(*s))
      for s in [(4096, 6), (1, 6), (4096, 29)]],
    *[(f"K5 {s}", old_foot(*s), tprof.foot_rollout_cost(s[0], s[1], operand_floats=s[2]))
      for s in [(65536, 1000, 22), (65536, 10, 22 * 65536), (16384, 200, 22)]],
]


@pytest.mark.parametrize("old, cost", [c[1:] for c in OLD_AND_NEW],
                         ids=[c[0] for c in OLD_AND_NEW])
def test_each_bound_is_the_formula_chip_smoke_had_before(old, cost):
    """``chip_smoke.py`` scales the models' unit seconds to milliseconds; each
    unit agrees with the formula it replaced, and no other unit is counted."""
    times = {unit: 1e3 * t for unit, t in cost.unit_seconds(SXM).items()}
    for unit, t in times.items():
        assert t == pytest.approx(old.get(unit, 0.0), rel=1e-12, abs=0.0), unit


# ---------------------------------------------------------------------------
# (d) the chain, and the table on CPU tensors
# ---------------------------------------------------------------------------

def test_measure_chained_times_chains_of_ticks_applications():
    seen = []

    def step(c):
        seen.append(int(c))
        return c + 1

    t = tprof.measure_chained(step, torch.tensor(0), ticks=4, warmup=2, repeats=3)
    assert t > 0.0
    # the warm-up chains run on from the last output; each timed chain starts
    # from init, every application taking the previous one's output
    assert seen == list(range(8)) + [0, 1, 2, 3] * 3


def test_the_sol_table_on_cpu_tensors():
    from blf_tpu_torch.ops.cuda import admm, rollout

    admm.reset_counts()
    rollout.reset_counts()
    rows = tprof.sol_rows("cpu", batch=16, foot_batch=8)
    labels = [r["label"] for r in rows]
    assert labels == ["qp.factor_shared (1x)"] + [
        f"{kind} h={h} B=16" for h in (16, 32)
        for kind in ("admm_stage[f32]", "admm_stage[delta]", "admm_stage[split]",
                     "qp.solve_factored[cuda_delta]")] + [
        "foot_rollout[torch] (B=8)", "foot_rollout[cuda] (B=8)"]
    assert all(r["time_s"] > 0.0 and r["chip"] == "host CPU" for r in rows)
    scored = [r for r in rows if "tensor_core_util" in r]
    assert len(scored) == 9 and all(0.0 < r["sol_frac"] for r in scored)
    assert rows[0]["flops"] > 0.0 and rows[-2]["bytes"] > 0.0
    # on CPU tensors the kernels' plain versions ran: every mode, and K5
    assert admm.reference_count() > 0 and admm.tc_reference_count() > 0
    assert rollout.reference_count() > 0
    assert admm.launch_count() == 0 and admm.tc_launch_count() == 0
