"""The plain version of the batched Cholesky inverse (kernel K3) against the
JAX package's Pallas kernel in interpret mode.

On the CPU ``cholesky_inverse_lane`` runs its plain version, which repeats the
kernel's arithmetic column by column; the CUDA kernel itself is held against
that plain version on the card by ``chip_smoke.py`` phase ``kernels``.
Matrices are drawn as ``tests/test_pallas_linalg.py`` draws them
(``0.09 G G' + 2 I``, condition number of a few tens).

Tolerances: float32 1e-5 relative (the reference test's own limit: the same
recursion with another summation order inside the dot products); float64
1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.ops.pallas import linalg as jlinalg
from blf_tpu_torch.ops.cuda import linalg as tlinalg


def spd(rng, B, n, dtype):
    K = rng.normal(size=(B, n, n)).astype(dtype) * 0.3
    return K @ np.swapaxes(K, -1, -2) + np.eye(n, dtype=dtype) * 2


def rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("B,n", [(3, 5), (16, 35), (7, 64), (2, 1)])
def test_f32_matches_pallas_interpret(B, n):
    K = spd(np.random.default_rng(0), B, n, np.float32)
    ref = np.asarray(jlinalg.cholesky_inverse_lane(jnp.asarray(K), interpret=True))
    tlinalg.reset_counts()
    out = tlinalg.cholesky_inverse_lane(torch.as_tensor(K))
    assert tlinalg.reference_count() == 1 and tlinalg.launch_count() == 0
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, n, n)
    assert rel(out.numpy(), ref) < 1e-5
    assert rel(out.numpy(), np.linalg.inv(K.astype(np.float64))) < 1e-5


@pytest.mark.parametrize("B,n", [(3, 9), (5, 29), (4, 64)])
def test_f64_matches_pallas_interpret_and_numpy(B, n):
    K = spd(np.random.default_rng(4), B, n, np.float64)
    ref = np.asarray(jlinalg.cholesky_inverse_lane(jnp.asarray(K), interpret=True))
    out = tlinalg.cholesky_inverse_lane(torch.as_tensor(K)).numpy()
    assert out.dtype == np.float64
    assert rel(out, ref) < 1e-10 and rel(out, np.linalg.inv(K)) < 1e-10
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
    ref = np.asarray(jlinalg.cholesky_inverse_lane(jnp.asarray(K), interpret=True))
    assert np.isnan(ref[2]).all() and np.isfinite(ref[[0, 1, 3]]).all()


def test_wrapper_checks_what_the_kernel_does_not_take():
    K = torch.as_tensor(spd(np.random.default_rng(1), 2, 4, np.float32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tlinalg.cholesky_inverse_lane(K.to("meta"))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        tlinalg.cholesky_inverse_lane_reference(K[0])
    with pytest.raises(ValueError, match="shared memory"):
        tlinalg.build_chol_lane(400)
    assert tlinalg.inverse_shared_bytes(64) == 4 * (2 * 64 * 65 + 64)
    assert tlinalg.REPLACES == "blf_tpu/ops/pallas/linalg.py:61"
