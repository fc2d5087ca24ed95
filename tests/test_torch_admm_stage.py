"""Port parity of the module that holds the ADMM stage kernel.

``blf_tpu_torch.ops.cuda.admm.admm_stage`` on CPU tensors (where the wrapper
runs the kernel's plain version) against

- the JAX package's Pallas kernel in interpret mode, ``matmul="f32"``, in
  float32 (1e-5 relative: same recursion, other evaluation order), and
- the five-line v-space recursion written in numpy, in float64 (1e-12; the
  Pallas kernel accumulates in float32, so it is no float64 yardstick).

The CUDA kernel itself cannot run without a GPU; ``chip_smoke.py`` holds it
against the same plain version on the card.

The reference's own f32 mode is six bf16 passes a product
(``Precision.HIGHEST``). The same passes on Hopper's tensor cores were tried
for this kernel: an emulation of them (the tensor cores' f32 accumulation
modelled as truncation) is held to the plain version here. It holds the
tolerance, as the tensor-core kernel did on the card; but there the fleet
tick lost lanes on its hardest ticks, which the model does not reproduce, so
the kernel stays on the FMA units (PERF.md section 6). Run as a script, this
file is that study at the fleet tick's shape, on the tick's own stages.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models.lipm import LIPMParams
from blf_tpu.mpc.dcm import build_dcm_qp
from blf_tpu.mpc.qp import factor_shared_qp
from blf_tpu.ops.pallas.admm import admm_stage as pallas_admm_stage
from blf_tpu_torch.ops.cuda import admm as port
from test_torch_wbc_loop import run_reference

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

ALPHA = 1.6


def stage_problem(horizon, B, np_dtype, seed=0):
    """Stage inputs of the horizon-``horizon`` DCM transcription, as numpy:
    the JAX package's own factorization, scaled bounds (polygon rows have
    l = -inf), a random iterate and s spread over [1e-2, 1e2]. Made once per
    process (the two references compile anew for every call); a caller that
    changes an array copies it first."""
    return dict(_stage_problem(horizon, B, np.dtype(np_dtype), seed))


@functools.lru_cache(maxsize=None)
def _stage_problem(horizon, B, np_dtype, seed):
    jd = jnp.dtype(np_dtype)
    N = horizon
    params = LIPMParams(jnp.asarray(0.9, jd), jnp.asarray(9.81, jd))
    zr, dr = jnp.zeros((N, 2), jd), jnp.zeros((N + 1, 2), jd)
    pA = jnp.tile(jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], jd),
                  (N, 1, 1))
    pb = jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.06, 0.06], jd), (N, 4))
    rng = np.random.default_rng(seed)
    dcm0 = jnp.asarray(rng.normal(0, 0.02, (B, 2)), jd)
    P, q, A, l, u = run_reference(build_dcm_qp, params, 0.1, dcm0, dr, zr, pA, pb)
    f = run_reference(factor_shared_qp, P, A, jnp.arange(A.shape[0]) < 2 * N)
    m, n = f.A_s.shape
    q = q + jnp.asarray(rng.normal(0, 0.05, (B, n)), jd)
    arrs = dict(
        v=rng.normal(0, 0.1, (B, m)),
        tau=np.zeros((B, n)),
        s=10.0 ** rng.uniform(-2, 2, (B, 1)),
        gq=np.asarray((f.c * (q * f.D)) @ f.W),
        l=np.asarray(f.E * l), u=np.asarray(f.E * u),
        G2=np.asarray(f.G2), d=np.asarray(f.d), base_rho=np.asarray(f.base_rho),
    )
    return {k: np.array(a, np_dtype, order="C") for k, a in arrs.items()}


ORDER = ("v", "tau", "s", "gq", "l", "u", "G2", "d", "base_rho")


def run_port(arrs, iters, dtype):
    args = [torch.as_tensor(arrs[k], dtype=dtype, device="cpu") for k in ORDER]
    v, tau = port.admm_stage(*args, iters=iters, alpha=ALPHA)
    return v.numpy(), tau.numpy()


def numpy_recursion(a, iters):
    """z = clip(v); w = rho (2z - v); tau = (w G2 - gq) / (1 + s d);
    v += alpha (tau G2' - z), with w carrying the per-lane factor s."""
    v = a["v"].copy()
    for _ in range(iters):
        z = np.minimum(np.maximum(v, a["l"]), a["u"])
        w = a["s"] * a["base_rho"] * (2.0 * z - v)
        tau = (w @ a["G2"] - a["gq"]) / (1.0 + a["s"] * a["d"])
        v = v + ALPHA * (tau @ a["G2"].T - z)
    return v, tau


@pytest.mark.parametrize("B", [256, 7])
@pytest.mark.parametrize("iters", [1, 25])
def test_f32_matches_pallas_interpret(B, iters):
    """(m, n) = (96, 64), float32, against the TPU kernel in interpret mode."""
    a = stage_problem(16, B, np.float32)
    assert a["G2"].shape == (96, 64) and np.isinf(a["l"]).any()
    ref_v, ref_tau = run_reference(
        pallas_admm_stage, *(jnp.asarray(a[k]) for k in ORDER), iters=iters, alpha=ALPHA,
        matmul="f32")
    v, tau = run_port(a, iters, torch.float32)
    ref_v, ref_tau = np.asarray(ref_v), np.asarray(ref_tau)
    assert v.dtype == np.float32 and v.shape == ref_v.shape
    assert np.abs(v - ref_v).max() <= 1e-5 * np.abs(ref_v).max()
    assert np.abs(tau - ref_tau).max() <= 1e-5 * np.abs(ref_tau).max()


@pytest.mark.parametrize("horizon,B", [(8, 33), (16, 7)])
def test_f64_matches_numpy_recursion(horizon, B):
    """(48, 32) and (96, 64), float64, -inf bounds included: 1e-12."""
    a = stage_problem(horizon, B, np.float64)
    assert np.isneginf(a["l"]).any()
    ref_v, ref_tau = numpy_recursion(a, 25)
    v, tau = run_port(a, 25, torch.float64)
    np.testing.assert_allclose(v, ref_v, atol=1e-12, rtol=0)
    np.testing.assert_allclose(tau, ref_tau, atol=1e-12, rtol=0)


@pytest.mark.parametrize("where", ["v", "bound"])
def test_nan_lane_stays_confined(where):
    """A poisoned lane stays non-finite (quarantine relies on it) and every
    other lane equals the clean run bit for bit."""
    a = stage_problem(8, 16, np.float64)
    clean_v, clean_tau = run_port(a, 10, torch.float64)
    bad = {k: x.copy() for k, x in a.items()}
    if where == "v":
        bad["v"][5, 3] = np.nan
    else:
        bad["l"][5, 0] = bad["u"][5, 0] = np.nan
    v, tau = run_port(bad, 10, torch.float64)
    assert not np.isfinite(v[5]).all() and not np.isfinite(tau[5]).all()
    others = np.arange(16) != 5
    assert np.array_equal(v[others], clean_v[others])
    assert np.array_equal(tau[others], clean_tau[others])


def test_cpu_tensors_take_the_plain_version_and_count_it():
    a = stage_problem(8, 4, np.float64)
    port.reset_counts()
    run_port(a, 2, torch.float64)
    assert port.reference_count() == 1 and port.launch_count() == 0
    with pytest.raises(ValueError, match="iters"):
        run_port(a, 0, torch.float64)


def test_shapes_the_kernel_cannot_hold_are_rejected():
    """The operator (rows padded by 4 floats) and a 32-lane tile's bounds, w,
    tau and the partial sums its two halves of 256 threads hand each other."""
    assert port.stage_shared_bytes(192, 128) == 216064
    port._check_shape(192, 128)
    port._check_shape(48, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        port._check_shape(48, 30)
    with pytest.raises(ValueError, match="shared memory"):
        port._check_shape(384, 256)


def random_qp_stage(m, n, B, seed=0):
    """Float32 stage inputs of a random shared QP at (m, n), factored by the
    port's factor_shared_qp: P = X X^T / n + 0.1 I, A ~ N(0, 1/n), an eighth
    of the rows equalities, a quarter of the others free below; a random
    iterate, s over four decades."""
    from blf_tpu_torch.mpc.qp import factor_shared_qp as t_factor

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
    X = rng.normal(size=(n, n))
    eq = np.arange(m) < max(1, m // 8)
    f = t_factor(t(X @ X.T / n + 0.1 * np.eye(n)), t(rng.normal(size=(m, n)) / np.sqrt(n)),
                 torch.as_tensor(eq))
    c0 = rng.normal(0, 0.1, (B, m))
    lo, hi = c0 - np.abs(rng.normal(0.2, 0.1, (B, m))), c0 + np.abs(rng.normal(0.2, 0.1, (B, m)))
    lo[:, eq], hi[:, eq] = c0[:, eq], c0[:, eq]
    lo[:, ~eq & (rng.random(m) < 0.25)] = -np.inf
    gq = ((f.c * (t(rng.normal(0, 1, (B, n))) * f.D)) @ f.W).contiguous()
    return (t(rng.normal(0, 0.1, (B, m))), torch.zeros(B, n), t(10.0 ** rng.uniform(-2, 2, (B, 1))),
            gq, (f.E * t(lo)).contiguous(), (f.E * t(hi)).contiguous(), f.G2.contiguous(),
            f.d.contiguous(), f.base_rho.contiguous())


@pytest.mark.parametrize("m,n", [(30, 13), (250, 97)])
def test_f32_at_an_n_not_a_multiple_of_4_pads_to_the_same_stage(m, n):
    """The f32 kernels take n a multiple of 4; admm_stage pads any other n
    with pad_columns (zero columns of G2, gq and tau, d = 1) and cuts tau
    back. The plain version on the padded inputs gives the unpadded stage to
    rounding (measured: bit for bit at both shapes), and the padded columns of
    tau stay exactly 0."""
    args = random_qp_stage(m, n, 33, seed=m + n)
    tau, gq, G2, d = args[1], args[3], args[6], args[7]
    tp, gp, Gp, dp = port.pad_columns(tau, gq, G2, d)
    k = n + (-n % 4)
    assert Gp.shape == (m, k) and gp.shape == (33, k) and tp.shape == (33, k) and dp.shape == (k,)
    assert bool((Gp[:, n:] == 0).all() and (gp[:, n:] == 0).all() and (dp[n:] == 1).all())
    assert torch.equal(Gp[:, :n], G2) and torch.equal(dp[:n], d)
    padded = (args[0], tp, args[2], gp, args[4], args[5], Gp, dp, args[8])
    v_p, tau_p = port.admm_stage_reference(*padded, iters=25, alpha=ALPHA)
    v, tau = port.admm_stage_reference(*args, iters=25, alpha=ALPHA)
    assert bool(torch.isfinite(v).all()) and bool((tau_p[:, n:] == 0).all())
    assert float((v_p - v).abs().max()) <= 1e-6 * float(v.abs().max())
    assert float((tau_p[:, :n] - tau).abs().max()) <= 1e-6 * float(tau.abs().max())
    whole = (tau[:, :12], gq[:, :12], G2[:, :12], d[:12])    # a multiple of 4: unchanged
    assert all(a is b for a, b in zip(port.pad_columns(*whole), whole))


def test_kernel_source_is_self_contained_cuda():
    """The kernel computes both products in its own body, on the FMA units
    (round-to-nearest sums): no library GEMM, no tensor-core product."""
    from blf_tpu_torch.ops.cuda import _build

    files = _build.source_files(port.SOURCE)
    assert [f.name for f in files] == ["admm_stage.cu"]
    src = files[0].read_text()
    assert "__global__" in src and "fmaf" in src
    for banned in ("cublas", "cutlass", "torch/", "ATen", "wgmma.", "mma.sync"):
        assert banned not in src
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS



@pytest.mark.parametrize("m,n,streams", [(192, 128, False), (48, 32, False), (200, 128, False),
                                         (240, 160, True), (640, 256, True), (960, 384, True)])
def test_mode_f32_chooses_its_kernel_by_shape(m, n, streams):
    """Past the resident kernel's shared memory, mode "f32" runs the kernel
    that streams the operator from L2 (the config-3 gait's (960, 384), the
    6-step gait's (640, 256), the first shapes past the limit); every shape
    the resident kernel took stays with it."""
    assert port.streams_operator(m, n) == streams
    assert port.streams_operator(m, n) == (port.stage_shared_bytes(m, n) > 232448)
    if streams:
        port._check_l2_shape(m, n)
        with pytest.raises(ValueError, match="shared memory"):
            port._check_shape(m, n)
    else:
        port._check_shape(m, n)


def test_streaming_kernel_layout_and_the_shapes_it_cannot_take():
    """Two 32-row chunks of G2 (stride n + 4), a 32-lane tile's tau, the
    chunk's w (stride 36) and the partial sums of G2 tau (8 splits, stride
    34): 187904 bytes at (960, 384), independent of m; n past about 500 or
    not a multiple of 4 still raises."""
    assert port.stage_l2_shared_bytes(960, 384) == 187904
    assert port.stage_l2_shared_bytes(640, 256) == 138752
    assert port.stage_l2_shared_bytes(240, 160) == 101888
    assert port.stage_l2_shared_bytes(10 ** 5, 384) == 187904
    port._check_l2_shape(10 ** 5, 496)
    port._check_l2_shape(960, 500)
    with pytest.raises(ValueError, match="multiple of 4"):
        port._check_l2_shape(960, 382)
    with pytest.raises(ValueError, match="shared memory"):
        port._check_l2_shape(960, 504)


@pytest.mark.parametrize("n,plan", [(4, (4, 8, 4)), (64, (4, 8, 4)), (160, (4, 8, 4)),
                                    (256, (4, 8, 4)), (260, (4, 8, 6)), (384, (4, 8, 6)),
                                    (388, (4, 8, 8)), (496, (4, 8, 8)), (500, (4, 8, 8))])
def test_streaming_kernel_tiles_take_one_round_of_the_block(n, plan):
    """G2[c] tau in 4-row tiles split 8 ways; G2[c]^T w[c] in tiles of
    ceil(n / 64) columns, rounded up to an even number and at least 4, x 4
    lanes, at most 64 x 8 = 512 of them, one a thread of the block (at n = 384
    exactly 512 of 6 x 4, where 4 x 4 tiles would take two rounds)."""
    rows, splits, columns = port.l2_plan(960, n)
    assert (rows, splits, columns) == plan
    assert (32 // rows) * 8 * splits == 512
    assert -(-n // columns) * 8 <= 512
    assert port.stage_l2_shared_bytes(960, n) <= 232448


def test_cpu_tensors_past_shared_memory_take_the_plain_version():
    rng = np.random.default_rng(0)
    B, m, n = 3, 640, 256
    shapes = {"v": (B, m), "tau": (B, n), "s": (B, 1), "gq": (B, n), "l": (B, m),
              "u": (B, m), "G2": (m, n), "d": (n,), "base_rho": (m,)}
    a = {k: np.abs(rng.normal(size=shape)).astype(np.float32) for k, shape in shapes.items()}
    port.reset_counts()
    v, tau = run_port(a, 2, torch.float32)
    assert port.reference_count() == 1 and port.launch_count() == port.l2_launch_count() == 0
    assert v.shape == (B, m) and tau.shape == (B, n) and np.isfinite(v).all()


def test_streaming_kernel_source_is_self_contained_cuda():
    """Both products in its own body on the FMA units, the operator copied
    into shared memory with cp.async; no library GEMM, no tensor cores."""
    from blf_tpu_torch.ops.cuda import _build

    files = _build.source_files(port.L2_SOURCE)
    assert [f.name for f in files] == ["admm_stage_l2.cu"]
    src = files[0].read_text()
    assert "__global__" in src and "fmaf" in src and "__pipeline_memcpy_async" in src
    for banned in ("cublas", "cutlass", "torch/", "ATen", "wgmma.", "mma.sync"):
        assert banned not in src


# --------------------------------------------------------------------------
# the six-pass product of csrc/admm_stage.cu, emulated in torch
# --------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def _pieces(x):
    """hi, mid, lo: three bf16 values whose sum is x exactly (float32)."""
    hi = _bf16(x)
    mid = _bf16(x - hi)
    return hi, mid, _bf16(x - hi - mid)


def _toward_zero(s):
    """float64 -> float32, rounded toward zero."""
    r = s.to(torch.float32)
    return torch.where(r.double().abs() > s.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def _tensor_core_sum(x, a, acc=None):
    """``acc + x @ a`` as the tensor cores are modelled to sum it: 16 terms
    (a k step) at a time, each exact product and the accumulator aligned to
    the largest of them and truncated to 24 bits, summed, and rounded toward
    zero to float32 (pessimistic: no guard bits)."""
    for k0 in range(0, x.shape[1], 16):
        terms = x[:, k0:k0 + 16, None].double() * a[None, k0:k0 + 16].double()
        if acc is not None:
            terms = torch.cat([acc.double()[:, None], terms], dim=1)
        top = terms.abs().amax(dim=1, keepdim=True)
        quantum = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 24)
        quantum = torch.where(top > 0, quantum, torch.ones_like(quantum))
        acc = _toward_zero((torch.trunc(terms / quantum) * quantum).sum(dim=1))
    return acc


def six_pass_product(x, a_pieces):
    """``x @ A`` in the kernel's order: the five small passes (lh, mm, hl,
    mh, hm) into one accumulator, then the hh pass one k step at a time from
    zero, each added in float32 round-to-nearest."""
    (ah, am, al), (xh, xm, xl) = a_pieces, _pieces(x)
    acc = None
    for xp, ap in ((xh, al), (xm, am), (xl, ah), (xh, am), (xm, ah)):
        acc = _tensor_core_sum(xp, ap, acc)
    for k0 in range(0, x.shape[1], 16):
        acc = acc + _tensor_core_sum(xh[:, k0:k0 + 16], ah[k0:k0 + 16])
    return acc


def six_pass_stage(v, tau, s, gq, l, u, G2, d, base_rho, *, iters, alpha):
    """:func:`admm_stage_reference`'s f32 recursion with the six-pass
    products (float32 tensors)."""
    sdinv = s / (1.0 + s * d)
    gqs = gq / s
    g2 = _pieces(G2)
    g2t = tuple(p.T for p in g2)
    for _ in range(iters):
        z = torch.minimum(torch.maximum(v, l), u)
        w = base_rho * (2.0 * z - v)
        tau = (six_pass_product(w, g2) - gqs) * sdinv
        v = v + alpha * (six_pass_product(tau, g2t) - z)
    return v, tau


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


SIX_PASS_LANES = 64


def test_six_pass_emulation_holds_the_plain_version():
    """Six-pass bf16 products at (96, 64), the first 64 lanes of the inputs
    of ``test_f32_matches_pallas_interpret``, 25 iterations: within
    chip_smoke.py's REL_TOL = 1e-5 of the exact f32 plain version (measured
    6.0e-6; the plain version itself lies 6.8e-6 from float64 on these
    lanes; on all 256, 1.2e-6 and 1.4e-6), and a NaN lane confined. The
    pieces hold every normal float32 exactly. In this model one product's
    error is smaller than the plain version's and about as often toward zero
    as away (measured 53 %, plain 50 %): what cost the card's tensor-core
    kernel lanes on the fleet tick is not in the model."""
    a = stage_problem(16, 256, np.float32)
    lanes = lambda k: a[k][:SIX_PASS_LANES] if k in ORDER[:6] else a[k]
    args = [torch.as_tensor(lanes(k)) for k in ORDER]
    x = torch.cat([args[0].flatten(), args[6].flatten(), torch.tensor([1e-30, -1e30, 0.0])])
    assert torch.equal(sum(_pieces(x)), x)
    v6, t6 = six_pass_stage(*args, iters=25, alpha=ALPHA)
    vp, tp = port.admm_stage_reference(*args, iters=25, alpha=ALPHA)
    assert max(_rel(v6, vp), _rel(t6, tp)) <= 1e-5
    args[0] = args[0].clone()
    args[0][5, 3] = float("nan")
    vn, tn = six_pass_stage(*args, iters=2, alpha=ALPHA)
    vc, tc = six_pass_stage(*[torch.as_tensor(lanes(k)) for k in ORDER], iters=2, alpha=ALPHA)
    others = torch.arange(SIX_PASS_LANES) != 5
    assert not bool(torch.isfinite(vn[5]).all()) and torch.equal(vn[others], vc[others])


def study(lanes=1024, ticks=10):
    """The six-pass emulation against the plain version at the fleet tick's
    (192, 128): on stage_problem's cold inputs and on both stages of the
    port's own f32 tick (``backend="cuda"``, the plain version on the CPU) at
    ticks 1, 3 and ``ticks``; each beside the plain version's own distance
    from float64."""
    import json
    from unittest import mock

    from blf_tpu_torch.mpc import qp as tqp
    from blf_tpu_torch.parallel.sweep import init_fleet, make_fleet_step
    from blf_tpu_torch.problems import stationary_push_recovery

    torch.set_num_threads(8)

    def row(name, args, kw):
        v6, t6 = six_pass_stage(*args, **kw)
        vp, tp = port.admm_stage_reference(*args, **kw)
        ve, te = port.admm_stage_reference(*(x.double() for x in args), **kw)
        out = {"inputs": name, "B": args[0].shape[0], "iters": kw["iters"],
               "six_pass_vs_plain": max(_rel(v6, vp), _rel(t6, tp)),
               "six_pass_vs_float64": max(_rel(v6.double(), ve), _rel(t6.double(), te)),
               "plain_vs_float64": max(_rel(vp.double(), ve), _rel(tp.double(), te))}
        print(json.dumps(out), flush=True)

    a = stage_problem(32, lanes, np.float32)
    row("stage_problem", [torch.as_tensor(a[k]) for k in ORDER], dict(iters=25, alpha=ALPHA))
    problem = stationary_push_recovery(lanes, 32, seed=0, device="cpu", dtype=torch.float32)
    refs = (problem.dcm_ref, problem.zmp_ref, problem.poly_A, problem.poly_b)
    seen = []

    def record(*args, **kw):
        seen.append((args, kw))
        return port.admm_stage(*args, **kw)

    state = init_fleet(lanes, 32, problem.num_constraints, problem.dcm0, problem.com0,
                       device="cpu", dtype=torch.float32)
    step = make_fleet_step(problem.params, problem.dt, iterations=50, backend="cuda",
                           device="cpu")
    with mock.patch.object(tqp, "admm_stage", record):
        for _ in range(ticks):
            state, _ = step(state, problem.disturbance[:lanes], *refs)
    for tick in (1, 3, ticks):
        for stage in (0, 1):
            args, kw = seen[2 * (tick - 1) + stage]
            row(f"tick{tick}_stage{stage + 1}", list(args),
                dict(iters=kw["iters"], alpha=kw["alpha"]))


if __name__ == "__main__":
    study()
