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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from blf_tpu.ops.pallas import linalg as jlinalg
from blf_tpu_torch.ops.cuda import linalg as tlinalg
from test_torch_wbc_loop import run_reference


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
        ref = np.asarray(run_reference(jlinalg.cholesky_inverse_lane, jnp.asarray(K),
                                       interpret=True))
        assert rel(out.numpy(), ref) < 1e-5
    assert rel(out.numpy(), np.linalg.inv(K.astype(np.float64))) < 1e-5


@pytest.mark.parametrize("B,n", [(3, 9), (5, 29), (4, 64)])
def test_f64_matches_pallas_interpret_and_numpy(B, n):
    K = spd(np.random.default_rng(4), B, n, np.float64)
    out = tlinalg.cholesky_inverse_lane(torch.as_tensor(K)).numpy()
    assert out.dtype == np.float64
    if n <= INTERPRET_MAX_N:
        ref = np.asarray(run_reference(jlinalg.cholesky_inverse_lane, jnp.asarray(K),
                                       interpret=True))
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
    ref = np.asarray(run_reference(jlinalg.cholesky_inverse_lane, jnp.asarray(K),
                                   interpret=True))
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


@pytest.mark.parametrize("B,n", [(3, 1), (5, 6), (4, 9)])
def test_solve_f32_matches_pallas_interpret(B, n):
    rng = np.random.default_rng(n)
    K, b = spd(rng, B, n, np.float32), rhs(rng, B, n, np.float32)
    ref = np.asarray(run_reference(jlinalg.cholesky_solve_lane, jnp.asarray(K),
                                   jnp.asarray(b), interpret=True))
    tlinalg.reset_counts()
    out = tlinalg.cholesky_solve_lane(torch.as_tensor(K), torch.as_tensor(b))
    assert tlinalg.solve_reference_count() == 1 and tlinalg.solve_launch_count() == 0
    assert tlinalg.reference_count() == 0
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, n)
    assert rel(out.numpy(), ref) < 1e-5
    exact = np.linalg.solve(K.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    assert rel(out.numpy(), exact) < 1e-5


@pytest.mark.parametrize("B,n", [(3, 1), (5, 6), (4, 9)])
def test_solve_f64_matches_numpy_and_pallas_interpret(B, n):
    rng = np.random.default_rng(10 + n)
    K, b = spd(rng, B, n, np.float64), rhs(rng, B, n, np.float64)
    out = tlinalg.cholesky_solve_lane(torch.as_tensor(K), torch.as_tensor(b)).numpy()
    assert out.dtype == np.float64
    assert rel(out, np.linalg.solve(K, b[..., None])[..., 0]) < 1e-10
    ref = np.asarray(run_reference(jlinalg.cholesky_solve_lane, jnp.asarray(K),
                                   jnp.asarray(b), interpret=True))
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
    ref = np.asarray(run_reference(jlinalg.cholesky_solve_lane, jnp.asarray(K),
                                   jnp.asarray(b), interpret=True))
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
    with pytest.raises(ValueError, match="shared memory"):
        tlinalg.build_chol_solve(400)
    assert tlinalg.solve_shared_bytes(6) == 4 * (6 * 7 + 18)
    assert tlinalg.SOLVE_REPLACES == "blf_tpu/ops/pallas/linalg.py:81"
