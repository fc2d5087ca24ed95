"""Port parity of the ADMM stage's reduced-precision modes, ``"split"`` and
``"delta"``, whose CUDA kernel runs on Hopper's tensor cores.

``blf_tpu_torch.ops.cuda.admm.admm_stage(..., matmul=mode)`` on CPU tensors
(where the wrapper runs the kernel's plain version) against the JAX package's
Pallas kernel in interpret mode, and the backends ``"cuda_split"`` /
``"cuda_delta"`` of ``solve_qp_factored`` against the reference's
``"pallas_split"`` / ``"pallas"``. Both sides round to bf16 at the same places
and take exact products of bf16 values, so they part only by the order of
their float32 sums; but a bf16 rounding that flips by one place between two
orders moves a ``delta`` increment by 2^-8 of itself, so ``delta`` away from a
fixed point is held looser than ``split``.

The CUDA kernel itself cannot run without a GPU; ``chip_smoke.py`` holds it
against the same plain version on the card.

Run as a script, this file is the study behind the tolerances of
``chip_smoke.py``'s checks of the kernel (``PERF.md``): the plain version in
two float32 summation orders (the reference's, and the kernel's: pass after
pass into one accumulator, 16 contraction terms at a time) on the card's
inputs, computed on the CPU.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.mpc import qp as jqp
from blf_tpu.ops.pallas.admm import admm_stage as pallas_admm_stage
from blf_tpu_torch.convert import factors_from_numpy
from blf_tpu_torch.mpc import qp as tqp
from blf_tpu_torch.ops.cuda import _build
from blf_tpu_torch.ops.cuda import admm as port
from test_torch_admm_stage import ALPHA, ORDER, stage_problem
from test_torch_qp_shared import fleet_problem, is_eq_of
from test_torch_wbc_loop import run_reference

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

# relative to the largest |entry|: measured at most 2.5e-5 (split, and the
# 3-pass first iteration of delta) and 5.4e-3 (delta after 4 iterations from a
# cold, random iterate, whose increments are as large as the iterate itself)
SPLIT_TOL = 1e-4
DELTA_COLD_TOL = 2e-2
# delta from a settled iterate: measured at most 4.5e-6; dropping the
# operator's lo pass from the increments' products parts by 6.6e-5 at B = 256
DELTA_WARM_TOL = 2e-5


def run_port(arrs, iters, matmul):
    args = [torch.as_tensor(arrs[k], device="cpu") for k in ORDER]
    v, tau = port.admm_stage(*args, iters=iters, alpha=ALPHA, matmul=matmul)
    return v.numpy(), tau.numpy()


def run_pallas(arrs, iters, matmul):
    v, tau = run_reference(pallas_admm_stage, *(jnp.asarray(arrs[k]) for k in ORDER),
                           iters=iters, alpha=ALPHA, matmul=matmul)
    return np.asarray(v), np.asarray(tau)


def rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("matmul", ["split", "delta"])
@pytest.mark.parametrize("B", [256, 7])
@pytest.mark.parametrize("iters", [1, 4])
def test_plain_version_matches_pallas_interpret(matmul, B, iters):
    """(m, n) = (96, 64), float32, -inf bounds, a random iterate and s over
    four decades. Delta reaches its increments from iteration 2 on."""
    a = stage_problem(16, B, np.float32)
    assert a["G2"].shape == (96, 64) and np.isinf(a["l"]).any()
    ref_v, ref_tau = run_pallas(a, iters, matmul)
    v, tau = run_port(a, iters, matmul)
    assert v.dtype == np.float32 and v.shape == ref_v.shape
    tol = DELTA_COLD_TOL if (matmul == "delta" and iters > 1) else SPLIT_TOL
    assert rel(v, ref_v) <= tol and rel(tau, ref_tau) <= tol


@pytest.mark.parametrize("B", [256, 7])
def test_delta_from_a_settled_iterate_matches_pallas_interpret(B):
    """The production pattern: the increments are small near a fixed point,
    so delta agrees as closely as split does (4 iterations from the iterate
    of 200 exact ones)."""
    a = stage_problem(16, B, np.float32)
    v200, _ = run_port(a, 200, "f32")
    a = dict(a, v=v200)
    ref_v, ref_tau = run_pallas(a, 4, "delta")
    v, tau = run_port(a, 4, "delta")
    assert rel(v, ref_v) <= DELTA_WARM_TOL and rel(tau, ref_tau) <= DELTA_WARM_TOL


@pytest.mark.parametrize("matmul", ["split", "delta"])
@pytest.mark.parametrize("where", ["v", "bound"])
def test_nan_lane_stays_confined(matmul, where):
    """A poisoned lane stays non-finite and every other lane equals the clean
    run bit for bit."""
    a = stage_problem(8, 16, np.float32)
    clean_v, clean_tau = run_port(a, 10, matmul)
    bad = {k: x.copy() for k, x in a.items()}
    if where == "v":
        bad["v"][5, 3] = np.nan
    else:
        bad["l"][5, 0] = bad["u"][5, 0] = np.nan
    v, tau = run_port(bad, 10, matmul)
    assert not np.isfinite(v[5]).all() and not np.isfinite(tau[5]).all()
    others = np.arange(16) != 5
    assert np.array_equal(v[others], clean_v[others])
    assert np.array_equal(tau[others], clean_tau[others])


@functools.lru_cache(maxsize=None)
def _gait_stage(num_steps, B):
    """The first stage ``plan_gait(shared=True, backend="cuda")`` hands K1 on
    the port's ``gait_fleet(B, num_steps)`` (CPU, float32): the gait's own
    operator, scaled bounds and gq, with a random iterate and s spread over
    four decades, as numpy. A caller that changes an array copies it."""
    from unittest import mock

    from blf_tpu_torch.planners.gait import plan_gait
    from blf_tpu_torch.problems import gait_fleet

    seen = []

    def record(*args, **kw):
        seen.append(args)
        return port.admm_stage(*args, **kw)

    with mock.patch.object(tqp, "admm_stage", record):
        plan_gait(*gait_fleet(B, num_steps=num_steps, device="cpu", dtype=torch.float32),
                  iterations=25, shared=True, backend="cuda")
    rng = np.random.default_rng(B)
    a = {k: t.numpy().copy() for k, t in zip(ORDER, seen[0])}
    a["v"] = rng.normal(0, 0.1, a["v"].shape).astype(np.float32)
    a["s"] = (10.0 ** rng.uniform(-2, 2, a["s"].shape)).astype(np.float32)
    return a


@pytest.mark.parametrize("matmul", ["split", "delta"])
@pytest.mark.parametrize("iters", [1, 4])
def test_plain_version_past_shared_memory_matches_pallas_interpret(matmul, iters):
    """(m, n) = (320, 128), the 2-step gait's own operator, past what the
    resident tensor-core kernel holds (m > 192: on the card the streaming
    kernel runs it), B 256, a random iterate; the file's limits."""
    a = _gait_stage(2, 256)
    assert a["G2"].shape == (320, 128) and port.tc_streams_operator(320, 128)
    assert np.isinf(a["l"]).any()
    ref_v, ref_tau = run_pallas(a, iters, matmul)
    v, tau = run_port(a, iters, matmul)
    tol = DELTA_COLD_TOL if (matmul == "delta" and iters > 1) else SPLIT_TOL
    assert rel(v, ref_v) <= tol and rel(tau, ref_tau) <= tol


def test_reduced_modes_take_float32_only_and_known_names():
    a = stage_problem(8, 4, np.float64)
    args = [torch.as_tensor(a[k]) for k in ORDER]
    with pytest.raises(TypeError, match="float32 only"):
        port.admm_stage(*args, iters=2, alpha=ALPHA, matmul="delta")
    with pytest.raises(ValueError, match="unknown matmul"):
        port.admm_stage(*args, iters=2, alpha=ALPHA, matmul="bf16")


class SharedFleet:
    """The reference's own gate: batch 256 of the horizon-16 fleet, float32,
    with the JAX package's factorization handed to the port."""

    _cache = {}

    @classmethod
    def get(cls):
        if not cls._cache:
            P, q, A, l, u = fleet_problem(256, np.float32, horizon=16)
            fj = run_reference(jqp.factor_shared_qp, jnp.asarray(P), jnp.asarray(A),
                               jnp.asarray(is_eq_of(A, 16)))
            ft = factors_from_numpy(fj, device="cpu", dtype=torch.float32)
            cls._cache.update(P=P, q=q, A=A, l=l, u=u, fj=fj, ft=ft)
        return cls._cache


def f32(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("backend,jax_backend", [("cuda_delta", "pallas"),
                                                 ("cuda_split", "pallas_split")])
def test_solve_matches_the_reference_reduced_backend(backend, jax_backend):
    """The reference's contract for these modes (tests/test_pallas_admm.py:
    57-74), eps 1e-4, 150 iterations: converged counts within 2 and the plan
    within 1e-4 where both converged (measured: 252 = 252 and 251 of 252;
    3.4e-5 and 1.7e-6)."""
    c = SharedFleet.get()
    eps = dict(eps_abs=1e-4, eps_rel=1e-4, iterations=150)
    sol_j = jqp.solve_qp_factored(c["fj"], jnp.asarray(c["q"]), jnp.asarray(c["l"]),
                                  jnp.asarray(c["u"]), backend=jax_backend, **eps)
    sol_t = tqp.solve_qp_factored(c["ft"], f32(c["q"]), f32(c["l"]), f32(c["u"]),
                                  backend=backend, **eps)
    conv_j, conv_t = np.asarray(sol_j.converged), sol_t.converged.numpy()
    assert conv_j.sum() >= 250 and abs(int(conv_t.sum()) - int(conv_j.sum())) <= 2
    both = conv_j & conv_t
    np.testing.assert_allclose(sol_t.x.numpy()[both], np.asarray(sol_j.x)[both], atol=1e-4)
    assert sol_t.x.dtype == torch.float32 and not bool(sol_t.refined)


def test_delta_mode_warm_start_floor():
    """The reference's tests/test_pallas_admm.py:76-92 on the port: from the
    unrefined torch solution, 50 delta iterations stay at the fixed point on
    every lane the reference solved (measured 1.2e-5, 248 of 252 still
    flagged converged)."""
    c = SharedFleet.get()
    args = tuple(f32(c[k]) for k in ("P", "q", "A", "l", "u"))
    ref = tqp.solve_qp_shared(*args, iterations=200, refine=False)
    warm = tqp.solve_qp_shared(*args, iterations=50, backend="cuda_delta",
                               x0=ref.x, y0=ref.y, s0=ref.rho_scale)
    conv = ref.converged.numpy()
    assert conv.sum() >= 250
    np.testing.assert_allclose(warm.x.numpy()[conv], ref.x.numpy()[conv], atol=2e-5)
    assert int(warm.converged.numpy()[conv].sum()) >= int(conv.sum()) - 4


@pytest.mark.parametrize("backend", ["cuda_split", "cuda_delta"])
def test_cpu_tensors_take_the_plain_version_and_count_it(backend):
    """An odd batch, once a stage: plain runs of the tensor-core kernel's
    version are counted apart from the f32 kernel's, and nothing launches."""
    c = SharedFleet.get()
    port.reset_counts()
    sol = tqp.solve_qp_factored(c["ft"], f32(c["q"]), f32(c["l"][:29]),
                                f32(c["u"][:29]), iterations=75, backend=backend)
    assert port.tc_reference_count() == 3 and port.tc_launch_count() == 0
    assert port.reference_count() == 0 and port.launch_count() == 0
    assert tuple(sol.x.shape) == (29, 64) and bool(torch.isfinite(sol.x).all())
    with pytest.warns(UserWarning, match="refine=True is not supported"):
        sol = tqp.solve_qp_factored(c["ft"], f32(c["q"]), f32(c["l"][:29]),
                                    f32(c["u"][:29]), iterations=25, backend=backend,
                                    refine=True)
    assert not bool(sol.refined)


def test_shapes_and_shared_memory_of_the_tensor_core_kernel():
    """Both bf16 operator pairs (192 KB at (192, 128)) and one tile's operand
    buffers, w's hi and lo and tau's hi (32 KB for 32 lanes), the same in both
    modes; 16-lane tiles for an operator of one 64-row tile each way."""
    assert port.stage_tc_shared_bytes(192, 128, "split") == 229376
    assert port.stage_tc_shared_bytes(192, 128, "delta") == 229376
    assert port.stage_tc_shared_bytes(48, 32, "delta") == 24576
    assert [port.tc_lanes(m, n) for m, n in ((192, 128), (96, 64), (48, 32))] == [32, 32, 16]
    for m, n in ((192, 128), (48, 32), (96, 64)):
        for matmul in ("split", "delta"):
            port._check_tc_shape(m, n, matmul)
    with pytest.raises(ValueError, match="shared memory"):
        port._check_tc_shape(256, 192, "delta")
    with pytest.raises(ValueError, match="warpgroup"):    # n > m: tau's lo would not fit
        port._check_tc_shape(64, 96, "delta")
    assert port.tc_defines(48, 32, "delta") == {"ADMM_M": 48, "ADMM_N": 32, "ADMM_DELTA": 1,
                                                "ADMM_LANES": 16}
    assert port.tc_defines(192, 128, "split")["ADMM_LANES"] == 32


@pytest.mark.parametrize("m,n", [(960, 384), (640, 256), (320, 128), (240, 160), (64, 96),
                                 (250, 97), (193, 8)])
def test_shapes_the_resident_kernel_refuses_take_the_streaming_one(m, n):
    """Past shared memory, past m = 192, or n > m: the shapes _check_tc_shape
    refuses are exactly those tc_streams_operator sends to
    csrc/admm_stage_tc_l2.cu."""
    assert port.tc_streams_operator(m, n)
    with pytest.raises(ValueError):
        port._check_tc_shape(m, n, "delta")
    lanes, stages = port.tc_l2_plan(m, n)
    assert port.stage_tc_l2_shared_bytes(m, n, "delta") <= 232448
    assert port.tc_l2_defines(m, n, "split") == {"ADMM_M": m, "ADMM_N": n, "ADMM_DELTA": 0,
                                                  "ADMM_LANES": lanes, "ADMM_STAGES": stages}


@pytest.mark.parametrize("m,n", [(192, 128), (96, 64), (48, 32), (128, 128)])
def test_shapes_the_resident_kernel_holds_stay_with_it(m, n):
    assert not port.tc_streams_operator(m, n)
    port._check_tc_shape(m, n, "delta")


def test_streaming_kernel_plan_and_shared_memory():
    """A ring of 16 KB tile pairs a warpgroup a slot (two consumer
    warpgroups) with a full and an empty mbarrier each, w's operand of a
    128-row chunk twice (by chunk parity) and tau's operand (n padded to 64),
    hi and lo each: 213056 bytes at (960, 384), the same in both modes and at
    any m; 32-lane tiles up to n = 640, 16 past it, the ring as deep as fits,
    n up to 2048. The split operators: 64 x 64 tiles, rows padded to whole
    chunks, a hi and a lo half each."""
    sizes = {(960, 384): 213056, (640, 256): 196672, (320, 128): 180288, (240, 160): 188480}
    for (m, n), size in sizes.items():
        for matmul in ("split", "delta"):
            assert port.stage_tc_l2_shared_bytes(m, n, matmul) == size
    assert port.stage_tc_l2_shared_bytes(10 ** 5, 384, "delta") == 213056
    assert [port.tc_l2_plan(100, n) for n in (384, 640, 704, 1024, 1025, 2048)] == \
        [(32, 4), (32, 3), (16, 4), (16, 4), (16, 4), (16, 2)]
    with pytest.raises(ValueError, match="n <= 2048"):
        port.tc_l2_plan(10, 2049)
    assert port.tc_l2_operator_bytes(960, 384) == 2 * 16 * 6 * 16384
    assert port.tc_l2_operator_bytes(250, 97) == 2 * 4 * 2 * 16384


@pytest.mark.parametrize("m,n,plan,shared", [
    (1, 1, (32, 4), 172096), (63, 64, (32, 4), 172096), (65, 384, (32, 4), 213056),
    (100, 1024, (16, 4), 213056), (129, 1025, (16, 4), 217152), (1000, 2048, (16, 2), 213024)])
def test_streaming_kernel_plan_at_edge_shapes(m, n, plan, shared):
    """The plan at n = 1, 64, 384, 1024, 1025 and 2048 and m off a multiple
    of 64: every plan within shared memory and within the registers of a
    consumer thread (t's, u's accumulators and a chunk's state of four values
    an element, at most 168 floats); m changes nothing but the operator's
    tiles."""
    assert port.tc_l2_plan(m, n) == plan
    lanes, stages = plan
    assert port.stage_tc_l2_shared_bytes(m, n, "delta") == shared <= 232448
    mt1 = -(-n // 64)
    assert (-(-mt1 // 2) + 5) * lanes // 2 <= 168
    assert port.tc_l2_operator_bytes(m, n) == 2 * (2 * -(-m // 128)) * mt1 * 16384
    assert port.tc_l2_defines(m, n, "delta")["ADMM_STAGES"] == stages


def test_cpu_tensors_past_shared_memory_take_the_plain_version_in_both_modes():
    a = _gait_stage(2, 256)
    port.reset_counts()
    for matmul in ("split", "delta"):
        run_port({k: x[:5] if x.ndim == 2 and x.shape[0] == 256 else x for k, x in a.items()},
                 2, matmul)
    assert port.tc_reference_count() == 2
    assert port.tc_launch_count() == port.tc_l2_launch_count() == port.reference_count() == 0


def test_kernel_source_is_self_contained_tensor_core_cuda():
    """Both products in the kernel's own body, on wgmma: no library GEMM."""
    src = (_build.CSRC_DIR / port.TC_SOURCE).read_text()
    assert "__global__" in src and "wgmma.mma_async" in src and "sm_90a" in src
    for banned in ("cublas", "cutlass", "torch/", "ATen", "mma.sync"):
        assert banned not in src
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert port.TC_REPLACES == "blf_tpu/ops/pallas/admm.py:138"


def test_streaming_kernel_source_is_self_contained_tensor_core_cuda():
    """Both products in its own body on wgmma, the operator tiles copied into
    shared memory by a producer warpgroup's bulk copies completing on
    mbarriers: no library GEMM, no warp-level mma, no block barrier in the
    ring."""
    files = _build.source_files(port.TC_L2_SOURCE)
    assert [f.name for f in files] == ["admm_stage_tc_l2.cu"]
    src = files[0].read_text()
    assert "__global__" in src and "wgmma.mma_async" in src
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    assert "mbarrier.try_wait.parity" in src and "setmaxnreg" in src
    assert "cp.async.cg" not in src and "cp.async.wait_group" not in src
    for banned in ("cublas", "cutlass", "torch/", "ATen", "mma.sync"):
        assert banned not in src
    assert port.TC_L2_REPLACES == "blf_tpu/ops/pallas/admm.py:138"


# --------------------------------------------------------------------------
# the study behind chip_smoke.py's tolerances (run this file as a script)
# --------------------------------------------------------------------------

def _summed_by_16(b, a, acc=None):
    """``acc + b @ a``, the contraction summed 16 terms at a time."""
    for k0 in range(0, b.shape[1], 16):
        part = b[:, k0:k0 + 16] @ a[k0:k0 + 16]
        acc = part if acc is None else acc + part
    return acc


def _kernel_order_dot3(a_pair, b):
    a_hi, a_lo = a_pair
    b_hi, b_lo = port._split(b)
    acc = _summed_by_16(b_hi, a_hi)
    acc = _summed_by_16(b_lo, a_hi, acc)
    return _summed_by_16(b_hi, a_lo, acc)


def _kernel_order_dot2(a_pair, b16):
    return _summed_by_16(b16, a_pair[1], _summed_by_16(b16, a_pair[0]))


def study(lanes=4096, ticks=10):
    """The plain version in two float32 summation orders on the inputs
    chip_smoke.py gives the kernel, and the fleet tick's own warm stages."""
    import json
    from unittest import mock

    from blf_tpu_torch.mpc.dcm import build_dcm_qp
    from blf_tpu_torch.parallel.sweep import init_fleet, make_fleet_step
    from blf_tpu_torch.problems import stationary_push_recovery

    torch.set_num_threads(8)
    kernel_order = (mock.patch.object(port, "_lsplit_dot3", _kernel_order_dot3),
                    mock.patch.object(port, "_lsplit_dot2", _kernel_order_dot2))

    def both_orders(fn):
        first = fn()
        with kernel_order[0], kernel_order[1]:
            return first, fn()

    def rel_t(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rows = []
    for horizon in (32, 8):
        m, n = 6 * horizon, 4 * horizon
        problem = stationary_push_recovery(lanes, horizon, seed=0, device="cpu",
                                           dtype=torch.float32)
        refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
        # cold inputs, as chip_smoke.stage_inputs draws them
        rng = np.random.default_rng(lanes)
        as_t = lambda x: torch.as_tensor(x, dtype=torch.float32)
        _, q, _, l, u = build_dcm_qp(problem.params, problem.dt,
                                     as_t(rng.normal(0, 0.02, (lanes, 2))), *refs)
        P, _, A, _, _ = build_dcm_qp(problem.params, problem.dt, problem.dcm0[None], *refs)
        f = tqp.factor_shared_qp(P, A, torch.arange(A.shape[0]) < 2 * horizon)
        q = q + as_t(rng.normal(0, 0.05, (lanes, n)))
        cold = [as_t(rng.normal(0, 0.1, (lanes, m))), torch.zeros((lanes, n)),
                as_t(10.0 ** rng.uniform(-2, 2, (lanes, 1))),
                ((f.c * (q * f.D)) @ f.W).contiguous(), (f.E * l).contiguous(),
                (f.E * u).contiguous(), f.G2.contiguous(), f.d, f.base_rho]
        for mode in ("split", "delta"):
            for iters in (1, 2, 25):
                (v1, t1), (v2, t2) = both_orders(lambda: port.admm_stage_reference(
                    *cold, iters=iters, alpha=1.6, matmul=mode))
                rows.append({"shape": [m, n], "inputs": "cold", "matmul": mode,
                             "iters": iters, "rel_v": rel_t(v2, v1), "rel_tau": rel_t(t2, t1)})
                print(json.dumps(rows[-1]), flush=True)
        # the warm stages of the fleet tick: both stages of ticks 3 and 10
        seen = []

        def record(*args, **kw):
            seen.append((args, kw))
            return port.admm_stage(*args, **kw)

        state = init_fleet(lanes, horizon, problem.num_constraints, problem.dcm0,
                           problem.com0, device="cpu", dtype=torch.float32)
        step = make_fleet_step(problem.params, problem.dt, iterations=50,
                               backend="cuda_delta", device="cpu")
        dist = problem.disturbance[:lanes]
        with mock.patch.object(tqp, "admm_stage", record):
            for _ in range(ticks):
                state, _ = step(state, dist, *refs)
        for tick in (3, ticks):
            for stage in (0, 1):
                args, kw = seen[2 * (tick - 1) + stage]
                for mode in ("split", "delta"):
                    (v1, t1), (v2, t2) = both_orders(lambda: port.admm_stage_reference(
                        *args, **dict(kw, matmul=mode)))
                    rows.append({"shape": [m, n], "inputs": f"tick{tick}_stage{stage + 1}",
                                 "matmul": mode, "iters": kw["iters"],
                                 "rel_v": rel_t(v2, v1), "rel_tau": rel_t(t2, t1)})
                    print(json.dumps(rows[-1]), flush=True)
        if horizon == 32:
            cross_study(problem, refs, lanes, ticks, kernel_order)
    return rows


def cross_study(problem, refs, lanes, ticks, kernel_order):
    """One tick from the same state: cuda_delta in the two orders, and
    cuda_delta against cuda (f32), per lane: chip_smoke.py's cross_delta."""
    import json

    from blf_tpu_torch.parallel.sweep import init_fleet, make_fleet_step

    dist = problem.disturbance[:lanes]

    def step_of(backend):
        return make_fleet_step(problem.params, problem.dt, iterations=50,
                               backend=backend, device="cpu")

    delta, exact = step_of("cuda_delta"), step_of("cuda")
    state = init_fleet(lanes, 32, problem.num_constraints, problem.dcm0, problem.com0,
                       device="cpu", dtype=torch.float32)
    for k in range(1, ticks + 1):
        nxt, res = delta(state, dist, *refs)
        with kernel_order[0], kernel_order[1]:
            other, res_o = delta(state, dist, *refs)
        ex, res_x = exact(state, dist, *refs)
        both = (res.status == 0) & (res_x.status == 0)
        plan = lambda r: r.consensus_zmp0
        print(json.dumps({
            "tick": k,
            "orders_max_abs": {
                "consensus_zmp0": float((plan(res) - plan(res_o)).abs().max()),
                "dcm": float((nxt.dcm - other.dcm).abs().max()),
                "warm_y": float((nxt.warm_y - other.warm_y).abs().max())},
            "orders_status_mismatches": int((res.status != res_o.status).sum()),
            "converged_delta_f32": [int((res.status == 0).sum()), int((res_x.status == 0).sum())],
            "vs_f32_plan_both_converged": float((plan(res) - plan(res_x)).abs().amax(-1)[both].max()),
        }), flush=True)
        state = nxt


def reference_cold_ticks(lanes=4096, ticks=3):
    """Converged lanes of the first ticks of bench.py's workload in the delta
    mode, in both packages from the same cold state (the reference's
    "pallas" in interpret mode, the port's "cuda_delta" on the CPU), and in
    the exact modes beside them: the cold first tick is where delta leaves
    lanes above eps."""
    import json

    import jax

    from blf_tpu.models.lipm import LIPMParams as JLIPMParams
    from blf_tpu.parallel import sweep as jsweep
    from blf_tpu.parallel.mesh import make_mesh
    from blf_tpu_torch.parallel import sweep as tsweep
    from blf_tpu_torch.problems import stationary_push_recovery

    pr = stationary_push_recovery(lanes, 32, seed=0, device="cpu", dtype=torch.float32)
    refs_t = (pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
    refs_j = tuple(jnp.asarray(r.numpy()) for r in refs_t)
    pj = JLIPMParams(jnp.asarray(0.9, jnp.float32), jnp.asarray(9.81, jnp.float32))
    dist_j = jnp.asarray(pr.disturbance.numpy())
    for jax_backend, backend in (("pallas", "cuda_delta"), ("pallas_f32", "cuda")):
        step_j = jax.jit(jsweep.make_fleet_step(make_mesh(1, model_axis=1), pj, 0.1,
                                                iterations=50, backend=jax_backend))
        state_j = jsweep.init_fleet(lanes, 32, pr.num_constraints, jnp.asarray(pr.dcm0.numpy()),
                                    jnp.asarray(pr.com0.numpy()), dtype=jnp.float32)
        step_t = tsweep.make_fleet_step(pr.params, 0.1, iterations=50, backend=backend,
                                        device="cpu")
        state_t = tsweep.init_fleet(lanes, 32, pr.num_constraints, pr.dcm0, pr.com0,
                                    device="cpu", dtype=torch.float32)
        for k in range(1, ticks + 1):
            state_j, res_j = step_j(state_j, dist_j, *refs_j)
            state_t, res_t = step_t(state_t, pr.disturbance, *refs_t)
            print(json.dumps({"tick": k, "blf_tpu": jax_backend, "port": backend,
                              "converged": [int(res_j.stats.num_converged),
                                            int(res_t.stats.num_converged)]}), flush=True)


if __name__ == "__main__":
    study()
    reference_cold_ticks()
