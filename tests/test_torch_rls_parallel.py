"""The port's parallel-in-time RLS (``estimators/rls_parallel.py``) against
``blf_tpu.estimators.rls_parallel`` and ``rls_scan``.

The cases of ``tests/test_rls_parallel.py`` (sequential trajectory,
forgetting factor, batched streams, fit against final, ground truth), on the
same numpy draws. The port's log-depth scan and ``rls_fit``'s one weighted
reduction sum in other orders than the reference's, so float64 and 1e-10,
never bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.estimators import rls as jrls
from blf_tpu.estimators import rls_parallel as jpar
from blf_tpu_torch.convert import rls_state_from_numpy, rls_state_to_numpy
from blf_tpu_torch.estimators import rls as trls
from blf_tpu_torch.estimators import rls_parallel as tpar
from test_torch_wbc_loop import run_reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)


def make_problem(seed, T=256, p=3, m=2, lam=1.0, batch=()):
    """``tests/test_rls_parallel.py::make_problem``'s draws on both sides."""
    rng = np.random.default_rng(seed)
    theta_true = rng.normal(size=(p,))
    A = rng.normal(size=(T,) + batch + (m, p))
    y = A @ theta_true + 0.1 * rng.normal(size=(T,) + batch + (m,))
    R = 0.01 * np.eye(m)
    P0 = np.broadcast_to(10.0 * np.eye(p), batch + (p, p))
    jax_side = (jrls.RLSParams(jnp.asarray(lam), jnp.asarray(R)),
                jrls.RLSState(jnp.zeros(batch + (p,)), jnp.asarray(P0)),
                jnp.asarray(A), jnp.asarray(y))
    t = lambda a: torch.as_tensor(np.array(a))
    state0 = rls_state_from_numpy({"theta": np.zeros(batch + (p,)), "covariance": P0},
                                  device="cpu", dtype=torch.float64)
    port = (trls.RLSParams(t(lam), t(R)), state0, t(A), t(y))
    return jax_side, port, theta_true


@pytest.mark.parametrize("seed, lam", [(0, 1.0), (1, 0.97)],
                         ids=["sequential_trajectory", "forgetting_factor"])
def test_trajectory_matches_the_reference(seed, lam):
    j, t, _ = make_problem(seed, lam=lam)
    final, thetas = tpar.rls_parallel(*t)
    ref_final, ref_thetas = run_reference(jpar.rls_parallel, *j)
    np.testing.assert_allclose(thetas.numpy(), np.asarray(ref_thetas), **TOL)
    for name, value in rls_state_to_numpy(final).items():
        np.testing.assert_allclose(value, np.asarray(getattr(ref_final, name)), **TOL)
    # and the sequential filter it restates, the reference's rls_scan
    seq_final, seq_thetas = run_reference(jrls.rls_scan, *j, save_trajectory=True)
    np.testing.assert_allclose(thetas.numpy(), np.asarray(seq_thetas), rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(final.covariance.numpy(), np.asarray(seq_final.covariance),
                               rtol=1e-8, atol=1e-8)


def test_batched_streams():
    j, t, _ = make_problem(2, T=64, batch=(5,), lam=0.99)
    final, _ = tpar.rls_parallel(*t)
    np.testing.assert_allclose(final.theta.numpy(),
                               np.asarray(run_reference(jpar.rls_parallel, *j)[0].theta), **TOL)
    np.testing.assert_allclose(final.theta.numpy(), trls.rls_scan(*t).theta.numpy(),
                               rtol=1e-8, atol=1e-8)


def test_fit_matches_final():
    j, t, _ = make_problem(3, lam=0.95)
    fit = tpar.rls_fit(*t)
    ref = run_reference(jpar.rls_fit, *j)
    for name, value in rls_state_to_numpy(fit).items():
        np.testing.assert_allclose(value, np.asarray(getattr(ref, name)), err_msg=name, **TOL)
    np.testing.assert_allclose(fit.theta.numpy(), trls.rls_scan(*t).theta.numpy(),
                               rtol=1e-8, atol=1e-8)


def test_recovers_ground_truth():
    _, t, theta_true = make_problem(4, T=4096)
    final, _ = tpar.rls_parallel(*t)
    np.testing.assert_allclose(final.theta.numpy(), theta_true, atol=5e-3)


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
def test_associative_scan_is_the_inclusive_prefix_in_order(T):
    """The scan against a left fold, with a combine that is associative but
    not commutative (2 x 2 matrix products): earlier elements on the left."""
    rng = np.random.default_rng(T)
    mats = torch.as_tensor(rng.normal(size=(T, 4, 2, 2)))
    prod = lambda a, b: (a[0] @ b[0],)
    (out,) = tpar.associative_scan(prod, (mats,))
    acc = mats[0]
    np.testing.assert_allclose(out[0].numpy(), acc.numpy(), **TOL)
    for i in range(1, T):
        acc = acc @ mats[i]
        np.testing.assert_allclose(out[i].numpy(), acc.numpy(), **TOL)


def test_sharded_stream_waits_for_the_multi_device_slice():
    _, t, _ = make_problem(6, T=8)
    with pytest.raises(NotImplementedError, match="4.5"):
        tpar.rls_parallel_sharded(*t, None, "stream")
