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


def test_six_pass_emulation_holds_the_plain_version():
    """Six-pass bf16 products at (96, 64), 256 lanes, 25 iterations: within
    chip_smoke.py's REL_TOL = 1e-5 of the exact f32 plain version (measured
    1.2e-6; the plain version itself lies 1.4e-6 from float64), and a NaN
    lane confined. The pieces hold every normal float32 exactly. In this
    model one product's error is smaller than the plain version's and about
    as often toward zero as away (measured 53 %, plain 50 %): what cost the
    card's tensor-core kernel lanes on the fleet tick is not in the model."""
    a = stage_problem(16, 256, np.float32)
    args = [torch.as_tensor(a[k]) for k in ORDER]
    x = torch.cat([args[0].flatten(), args[6].flatten(), torch.tensor([1e-30, -1e30, 0.0])])
    assert torch.equal(sum(_pieces(x)), x)
    v6, t6 = six_pass_stage(*args, iters=25, alpha=ALPHA)
    vp, tp = port.admm_stage_reference(*args, iters=25, alpha=ALPHA)
    assert max(_rel(v6, vp), _rel(t6, tp)) <= 1e-5
    args[0] = args[0].clone()
    args[0][5, 3] = float("nan")
    vn, tn = six_pass_stage(*args, iters=2, alpha=ALPHA)
    vc, tc = six_pass_stage(*[torch.as_tensor(a[k]) for k in ORDER], iters=2, alpha=ALPHA)
    others = torch.arange(256) != 5
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
