"""Port parity of the module that holds the ADMM stage kernel.

``blf_tpu_torch.ops.cuda.admm.admm_stage`` on CPU tensors (where the wrapper
runs the kernel's plain version) against

- the JAX package's Pallas kernel in interpret mode, ``matmul="f32"``, in
  float32 (1e-5 relative: same recursion, other evaluation order), and
- the five-line v-space recursion written in numpy, in float64 (1e-12; the
  Pallas kernel accumulates in float32, so it is no float64 yardstick).

The CUDA kernel itself cannot run without a GPU; ``chip_smoke.py`` holds it
against the same plain version on the card.
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
    assert port.stage_shared_bytes(192, 128) == 191488
    port._check_shape(192, 128)
    port._check_shape(48, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        port._check_shape(48, 30)
    with pytest.raises(ValueError, match="shared memory"):
        port._check_shape(384, 256)


def test_kernel_source_is_self_contained_cuda():
    """The kernel computes both products in its own body: no library GEMM."""
    from blf_tpu_torch.ops.cuda import _build

    src = (_build.CSRC_DIR / port.SOURCE).read_text()
    assert "__global__" in src and "fmaf" in src
    for banned in ("cublas", "cutlass", "torch/", "ATen"):
        assert banned not in src
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
