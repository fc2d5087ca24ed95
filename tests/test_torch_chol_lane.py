"""The plain versions of the batched Cholesky inverse (kernel K3) and of the
batched SPD solve (kernel K4) against the JAX package's Pallas kernels in
interpret mode, and against numpy in float64.

On the CPU ``cholesky_inverse_lane`` and ``cholesky_solve_lane`` run their
plain versions, which repeat the kernels' arithmetic column by column; the
CUDA kernels themselves are held against those plain versions on the card by
``chip_smoke.py`` phase ``kernels``. Matrices are drawn as
``tests/test_pallas_linalg.py`` draws them (``0.09 G G' + 2 I``, condition
number of a few tens).

Tolerances: float32 1e-5 relative (the reference test's own limit: the same
recursion with another summation order inside the dot products); float64
1e-10. The interpret-mode kernels unroll every column, so they run here only
at n <= 35; at n = 64 the plain version is held to float64 numpy.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from blf_tpu.ops.pallas import linalg as jlinalg
from blf_tpu_torch.ops.cuda import linalg as tlinalg
from test_torch_wbc_loop import reference_jit

# The reference kernels in interpret mode, each one program per input shape
# and dtype, compiled once a process (with ``reference_jit``'s options):
# tests that hand them the same shapes share the compile.
interpret_inverse = reference_jit(
    lambda K: jlinalg.cholesky_inverse_lane(K, interpret=True))
interpret_solve = reference_jit(
    lambda K, b: jlinalg.cholesky_solve_lane(K, b, interpret=True))


def spd(rng, B, n, dtype):
    K = rng.normal(size=(B, n, n)).astype(dtype) * 0.3
    return K @ np.swapaxes(K, -1, -2) + np.eye(n, dtype=dtype) * 2


def rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


INTERPRET_MAX_N = 35


@pytest.mark.parametrize("B,n", [(3, 5), (16, 35), (7, 64), (2, 1)])
def test_f32_matches_pallas_interpret(B, n):
    K = spd(np.random.default_rng(0), B, n, np.float32)
    tlinalg.reset_counts()
    out = tlinalg.cholesky_inverse_lane(torch.as_tensor(K))
    assert tlinalg.reference_count() == 1 and tlinalg.launch_count() == 0
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, n, n)
    if n <= INTERPRET_MAX_N:
        ref = np.asarray(interpret_inverse(jnp.asarray(K)))
        assert rel(out.numpy(), ref) < 1e-5
    assert rel(out.numpy(), np.linalg.inv(K.astype(np.float64))) < 1e-5


@pytest.mark.parametrize("B,n", [(3, 9), (5, 29), (4, 64)])
def test_f64_matches_pallas_interpret_and_numpy(B, n):
    K = spd(np.random.default_rng(4), B, n, np.float64)
    out = tlinalg.cholesky_inverse_lane(torch.as_tensor(K)).numpy()
    assert out.dtype == np.float64
    if n <= INTERPRET_MAX_N:
        ref = np.asarray(interpret_inverse(jnp.asarray(K)))
        assert rel(out, ref) < 1e-10
    assert rel(out, np.linalg.inv(K)) < 1e-10
    # L^-T L^-1 is formed from one factor: symmetric to rounding
    np.testing.assert_allclose(out, np.swapaxes(out, -1, -2), atol=1e-14)


@pytest.mark.parametrize("poison", ["nan", "not_spd", "zero_pivot"])
def test_a_failed_lane_is_nan_and_stays_local(poison):
    """A poisoned lane gives NaN in its whole output and nothing else moves:
    per-lane failure as data, where ``torch.linalg.cholesky`` would raise for
    the batch. The reference kernel does the same."""
    K = spd(np.random.default_rng(2), 4, 8, np.float32)
    clean = tlinalg.cholesky_inverse_lane(torch.as_tensor(K.copy()))
    if poison == "nan":
        K[2, 3, 1] = K[2, 1, 3] = np.nan
    elif poison == "not_spd":
        K[2, 5, 5] = -1.0
    else:
        K[2] = 0.0
    out = tlinalg.cholesky_inverse_lane(torch.as_tensor(K))
    assert bool(torch.isnan(out[2]).all())
    assert torch.equal(out[[0, 1, 3]], clean[[0, 1, 3]])
    ref = np.asarray(interpret_inverse(jnp.asarray(K)))
    assert np.isnan(ref[2]).all() and np.isfinite(ref[[0, 1, 3]]).all()


def test_wrapper_checks_what_the_kernel_does_not_take():
    K = torch.as_tensor(spd(np.random.default_rng(1), 2, 4, np.float32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tlinalg.cholesky_inverse_lane(K.to("meta"))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        tlinalg.cholesky_inverse_lane_reference(K[0])
    with pytest.raises(ValueError, match="shared memory"):
        tlinalg.build_chol_lane(400)
    # one warp a matrix, the matrix once, rows padded to a stride of 68
    assert tlinalg.inverse_shared_bytes(64) == 4 * 64 * 68
    assert tlinalg.REPLACES == "blf_tpu/ops/pallas/linalg.py:61"


@pytest.mark.parametrize("n,stride", [(1, 4), (4, 4), (5, 12), (29, 36), (35, 36), (64, 68),
                                      (169, 172), (238, 244)])
def test_inverse_layout(n, stride):
    """The least stride >= n that is 4 mod 8 (the eight rows of a 16-byte load
    phase on distinct banks, and room for the product's 4-wide tiles); every n
    up to 238 fits, 169 being the largest the first design took."""
    assert tlinalg.inverse_stride(n) == stride
    assert stride >= n and stride % 8 == 4 and stride >= 4 * -(-n // 4)
    assert tlinalg.inverse_shared_bytes(n) == 4 * n * stride <= 232448


def test_inverse_refuses_a_matrix_shared_memory_cannot_hold():
    assert tlinalg.inverse_shared_bytes(239) > 232448
    for n in (239, 0):
        with pytest.raises(ValueError, match="shared memory"):
            tlinalg.build_chol_lane(n)


# ---------------------------------------------------------------------------
# K4: the solve with one right-hand side
# ---------------------------------------------------------------------------

def rhs(rng, B, n, dtype):
    return rng.normal(size=(B, n)).astype(dtype)


N_REG = tlinalg.SOLVE_N_REG
# n = 1, the stack's 6, the last size solved one thread a matrix and the first
# one warp a matrix; B = 1 and either side of 128, which no block divides
SOLVE_CASES = ([(3, 1), (5, 6), (4, 9)]
               + [(B, n) for n in (1, 6, N_REG, N_REG + 1) for B in (1, 127, 129)])
SOLVE_B_MAX = 129


@functools.lru_cache(maxsize=None)
def solve_inputs(n, dtype, seed):
    """``SOLVE_B_MAX`` systems of size ``n`` and the reference kernel's
    solution in interpret mode, made once a process; a case takes the first B
    lanes (the kernel solves each lane on its own)."""
    rng = np.random.default_rng(seed)
    K, b = spd(rng, SOLVE_B_MAX, n, dtype), rhs(rng, SOLVE_B_MAX, n, dtype)
    ref = np.asarray(interpret_solve(jnp.asarray(K), jnp.asarray(b)))
    return K, b, ref


@pytest.mark.parametrize("B,n", SOLVE_CASES)
def test_solve_f32_matches_pallas_interpret(B, n):
    K, b, ref = (a[:B] for a in solve_inputs(n, np.float32, n))
    tlinalg.reset_counts()
    out = tlinalg.cholesky_solve_lane(torch.as_tensor(K), torch.as_tensor(b))
    assert tlinalg.solve_reference_count() == 1 and tlinalg.solve_launch_count() == 0
    assert tlinalg.reference_count() == 0
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, n)
    assert rel(out.numpy(), ref) < 1e-5
    exact = np.linalg.solve(K.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    assert rel(out.numpy(), exact) < 1e-5


@pytest.mark.parametrize("B,n", SOLVE_CASES)
def test_solve_f64_matches_numpy_and_pallas_interpret(B, n):
    K, b, ref = (a[:B] for a in solve_inputs(n, np.float64, 10 + n))
    out = tlinalg.cholesky_solve_lane(torch.as_tensor(K), torch.as_tensor(b)).numpy()
    assert out.dtype == np.float64 and out.shape == (B, n)
    assert rel(out, np.linalg.solve(K, b[..., None])[..., 0]) < 1e-10
    assert rel(out, ref) < 1e-10


@pytest.mark.parametrize("poison", ["nan", "not_spd", "zero_pivot"])
def test_a_failed_solve_lane_is_nan_and_stays_local(poison):
    rng = np.random.default_rng(6)
    K, b = spd(rng, 4, 6, np.float32), rhs(rng, 4, 6, np.float32)
    clean = tlinalg.cholesky_solve_lane(torch.as_tensor(K.copy()), torch.as_tensor(b))
    if poison == "nan":
        K[2, 3, 1] = K[2, 1, 3] = np.nan
    elif poison == "not_spd":
        K[2, 5, 5] = -1.0
    else:
        K[2] = 0.0
    out = tlinalg.cholesky_solve_lane(torch.as_tensor(K), torch.as_tensor(b))
    assert bool(torch.isnan(out[2]).all())
    assert torch.equal(out[[0, 1, 3]], clean[[0, 1, 3]])
    ref = np.asarray(interpret_solve(jnp.asarray(K), jnp.asarray(b)))
    assert np.isnan(ref[2]).all() and np.isfinite(ref[[0, 1, 3]]).all()


@pytest.mark.parametrize("batch", [(), (2, 3)], ids=["unbatched", "doubly_batched"])
def test_spd_solve_lane_takes_the_dense_solve_off_the_fleet_shape(batch):
    """Anything but one batch axis goes to the library's dense Cholesky solve,
    as the reference's ``cho_solve``; one batch axis goes to the kernel's
    wrapper."""
    rng = np.random.default_rng(8)
    K = spd(rng, int(np.prod(batch, dtype=int)), 6, np.float64).reshape(batch + (6, 6))
    b = rng.normal(size=batch + (6,))
    tlinalg.reset_counts()
    out = tlinalg.spd_solve_lane(torch.as_tensor(K), torch.as_tensor(b))
    assert tlinalg.solve_reference_count() == tlinalg.solve_launch_count() == 0
    assert tuple(out.shape) == batch + (6,)
    ref = np.asarray(jlinalg.spd_solve_lane(jnp.asarray(K), jnp.asarray(b)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-10, atol=1e-12)
    flat = tlinalg.spd_solve_lane(torch.as_tensor(K.reshape(-1, 6, 6)),
                                  torch.as_tensor(b.reshape(-1, 6)))
    assert tlinalg.solve_reference_count() == 1
    np.testing.assert_allclose(flat.numpy().reshape(out.shape), out.numpy(), rtol=1e-10)


def test_solve_wrapper_checks_what_the_kernel_does_not_take():
    K = torch.as_tensor(spd(np.random.default_rng(1), 2, 4, np.float32))
    b = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tlinalg.cholesky_solve_lane(K.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match=r"\(B, n\)"):
        tlinalg.cholesky_solve_lane_reference(K, b[:, :3])
    for n in (400, tlinalg.SOLVE_MAX_N + 1, 0):
        with pytest.raises(ValueError, match="shared memory"):
            tlinalg.build_chol_solve(n)
    # one thread a matrix at n = 6: 32 slots of K, b and one float of padding
    assert tlinalg.solve_shared_bytes(6) == 4 * 32 * (36 + 6 + 1)
    assert tlinalg.SOLVE_REPLACES == "blf_tpu/ops/pallas/linalg.py:81"


@pytest.mark.parametrize("n,path,threads,per_block,stride,opts_in", [
    (1, "thread", 32, 32, 3, False), (6, "thread", 32, 32, 43, False),
    (16, "thread", 32, 32, 273, False), (N_REG, "thread", 32, 32, 421, True),
    (N_REG + 1, "warp", 128, 4, 21, False), (29, "warp", 128, 4, 29, False),
    (64, "warp", 64, 2, 65, False), (110, "warp", 32, 1, 111, False),
    (111, "warp", 32, 1, 111, True), (239, "warp", 32, 1, 239, True)])
def test_solve_layout(n, path, threads, per_block, stride, opts_in):
    """Which path each n takes and its shared memory, up to the largest n
    taken (239, the first design's bound). Up to N_REG one thread a matrix,
    its slot K then b at an odd stride; past it one warp a matrix, rows at an
    odd stride, as many matrices a block (at most 4) as fit in the 48 KB a
    block gets without opting in, and one past that; the kernel opts in to
    more once a device."""
    plan = tlinalg.solve_plan(n)
    assert tuple(plan)[:4] == (path, threads, per_block, stride) and stride % 2 == 1
    per_matrix = stride if path == "thread" else n * stride
    assert plan.shared_bytes == 4 * per_block * per_matrix <= 232448
    assert tlinalg.solve_shared_bytes(n) == plan.shared_bytes
    assert (plan.shared_bytes > 48 * 1024) == opts_in
    assert tlinalg.SOLVE_MAX_N == 239 and N_REG == 20
