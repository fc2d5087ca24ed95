"""Port parity: LIPM/DCM closed forms, unrolled small-PSD solves and RLS.

The same numpy arrays (made from a seed) go through the JAX functions of
``blf_tpu`` and their counterparts in ``blf_tpu_torch`` (on ``device="cpu"``).
Default lane is float64; ``BLF_TPU_TEST_F32=1`` runs both sides in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import F32_LANE, tol

from blf_tpu.estimators import rls as jrls
from blf_tpu.models import lipm as jlipm
from blf_tpu.ops import linalg as jlinalg
from blf_tpu_torch.estimators import rls as trls
from blf_tpu_torch.models import lipm as tlipm
from blf_tpu_torch.ops import linalg as tlinalg

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

NP_DTYPE = np.float32 if F32_LANE else np.float64
T_DTYPE = torch.float32 if F32_LANE else torch.float64
DT = 0.1


def to_t(a):
    return torch.as_tensor(np.asarray(a, NP_DTYPE), dtype=T_DTYPE, device="cpu")


def to_j(a):
    return jnp.asarray(np.asarray(a, NP_DTYPE))


def params_pair():
    return (jlipm.LIPMParams(to_j(0.9), to_j(9.81)),
            tlipm.LIPMParams(to_t(0.9), to_t(9.81)))


def close(torch_out, jax_out, atol):
    np.testing.assert_allclose(torch_out.numpy(), np.asarray(jax_out),
                               atol=atol, rtol=0)


class TestLipm:
    ATOL = tol(1e-12, 1e-5)

    def setup_method(self):
        rng = np.random.default_rng(0)
        self.com = rng.normal(0, 0.1, (5, 2))
        self.dcm = rng.normal(0, 0.1, (5, 2))
        self.zmp = rng.normal(0, 0.1, (5, 2))

    def test_omega(self):
        pj, pt = params_pair()
        close(tlipm.lipm_omega(pt), jlipm.lipm_omega(pj), self.ATOL)

    @pytest.mark.parametrize("name", ["dcm_dynamics", "com_dynamics"])
    def test_continuous_dynamics(self, name):
        pj, pt = params_pair()
        a, b = (self.dcm, self.zmp) if name == "dcm_dynamics" else (self.com, self.dcm)
        close(getattr(tlipm, name)(pt, to_t(a), to_t(b)),
              getattr(jlipm, name)(pj, to_j(a), to_j(b)), self.ATOL)

    def test_dcm_discrete_step(self):
        pj, pt = params_pair()
        close(tlipm.dcm_discrete_step(pt, to_t(self.dcm), to_t(self.zmp), DT),
              jlipm.dcm_discrete_step(pj, to_j(self.dcm), to_j(self.zmp), DT),
              self.ATOL)

    def test_com_discrete_step(self):
        pj, pt = params_pair()
        close(tlipm.com_discrete_step(pt, to_t(self.com), to_t(self.dcm),
                                      to_t(self.zmp), DT),
              jlipm.com_discrete_step(pj, to_j(self.com), to_j(self.dcm),
                                      to_j(self.zmp), DT), self.ATOL)

    def test_dcm_backward_recursion(self):
        pj, pt = params_pair()
        rng = np.random.default_rng(1)
        knots, final = rng.normal(0, 0.2, (12, 2)), rng.normal(0, 0.2, 2)
        out = tlipm.dcm_backward_recursion(pt, to_t(knots), to_t(final), DT)
        assert tuple(out.shape) == (13, 2)
        close(out, jlipm.dcm_backward_recursion(pj, to_j(knots), to_j(final), DT),
              self.ATOL)

    def test_com_trajectory_from_dcm(self):
        pj, pt = params_pair()
        rng = np.random.default_rng(2)
        com0 = rng.normal(0, 0.1, (6, 2))
        dcm_traj = rng.normal(0, 0.1, (6, 9, 2))
        zmp = rng.normal(0, 0.1, (6, 8, 2))
        out = tlipm.com_trajectory_from_dcm(pt, to_t(com0), to_t(dcm_traj),
                                            to_t(zmp), DT)
        assert tuple(out.shape) == (6, 9, 2)
        close(out, jlipm.com_trajectory_from_dcm(pj, to_j(com0), to_j(dcm_traj),
                                                 to_j(zmp), DT), self.ATOL)


def random_psd(rng, batch, m):
    a = rng.normal(size=batch + (m, m + 2))
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(m)


class TestSmallPsd:
    ATOL = tol(1e-12, 1e-4)

    @pytest.mark.parametrize("m", [1, 2, 3])
    def test_solve_psd_small_matrix_rhs(self, m):
        rng = np.random.default_rng(m)
        S, B = random_psd(rng, (7,), m), rng.normal(size=(7, m, 4))
        close(tlinalg.solve_psd_small(to_t(S), to_t(B)),
              jlinalg.solve_psd_small(to_j(S), to_j(B)), self.ATOL)

    @pytest.mark.parametrize("m", [1, 2, 3])
    def test_solve_psd_vector_rhs_and_cholesky(self, m):
        rng = np.random.default_rng(10 + m)
        S, b = random_psd(rng, (3, 5), m), rng.normal(size=(3, 5, m))
        close(tlinalg.solve_psd(to_t(S), to_t(b)),
              jlinalg.solve_psd(to_j(S), to_j(b)), self.ATOL)
        close(tlinalg.cholesky_small(to_t(S)), jlinalg.cholesky_small(to_j(S)),
              self.ATOL)

    def test_large_falls_to_dense_solve(self):
        rng = np.random.default_rng(3)
        S, b = random_psd(rng, (2,), 10), rng.normal(size=(2, 10))
        x = tlinalg.solve_psd(to_t(S), to_t(b))
        np.testing.assert_allclose(
            np.einsum("bij,bj->bi", S, x.numpy()), b, atol=tol(1e-10, 1e-3))


class _Handler:
    """Duck-typed parameters handler with the reference's key names."""

    values = {"lambda": 0.97, "measurement_covariance": [1e-2, 2e-2],
              "state": [0.1, -0.2, 0.3], "state_covariance": [1.0, 2.0, 3.0]}

    def get_parameter(self, name, kind):
        return kind(self.values[name])

    def get_array(self, name):
        return np.asarray(self.values[name], NP_DTYPE)


class TestRls:
    ATOL = tol(1e-10, 1e-3)

    def pair(self, p=3, m=2):
        R = np.diag([1e-2, 2e-2][:m])
        pj = jrls.RLSParams(to_j(0.98), to_j(R))
        pt = trls.RLSParams(to_t(0.98), to_t(R))
        return pj, pt

    def test_step_on_a_batch(self):
        rng = np.random.default_rng(4)
        B, m, p = 16, 2, 3
        theta, cov = rng.normal(size=(B, p)), random_psd(rng, (B,), p)
        A, y = rng.normal(size=(B, m, p)), rng.normal(size=(B, m))
        pj, pt = self.pair()
        import jax

        ref = jax.vmap(lambda th, cv, A_, y_: jrls.rls_step(
            pj, jrls.RLSState(th, cv), A_, y_))(to_j(theta), to_j(cov),
                                                  to_j(A), to_j(y))
        out = trls.rls_step(pt, trls.RLSState(to_t(theta), to_t(cov)),
                            to_t(A), to_t(y))
        close(out.theta, ref.theta, self.ATOL)
        close(out.covariance, ref.covariance, self.ATOL)

    def test_scan_over_200_steps(self):
        rng = np.random.default_rng(5)
        T, m, p = 200, 2, 3
        truth = np.array([0.5, -1.0, 2.0])
        A = rng.normal(size=(T, m, p))
        y = A @ truth + 0.01 * rng.normal(size=(T, m))
        pj, pt = self.pair()
        ref, ref_traj = jrls.rls_scan(
            pj, jrls.RLSState(to_j(np.zeros(p)), to_j(np.eye(p) * 10.0)),
            to_j(A), to_j(y), save_trajectory=True)
        out, traj = trls.rls_scan(
            pt, trls.RLSState(to_t(np.zeros(p)), to_t(np.eye(p) * 10.0)),
            to_t(A), to_t(y), save_trajectory=True)
        close(out.theta, ref.theta, self.ATOL)
        close(out.covariance, ref.covariance, self.ATOL)
        close(traj, ref_traj, self.ATOL)
        np.testing.assert_allclose(out.theta.numpy(), truth, atol=2e-2)
        final_only = trls.rls_scan(
            pt, trls.RLSState(to_t(np.zeros(p)), to_t(np.eye(p) * 10.0)),
            to_t(A), to_t(y))
        assert torch.equal(final_only.theta, out.theta)

    def test_init_from_handler(self):
        pj, sj = jrls.init_from_handler(_Handler())
        pt, st = trls.init_from_handler(_Handler(), device="cpu", dtype=T_DTYPE)
        close(pt.lam, pj.lam, 1e-7)
        close(pt.measurement_covariance, pj.measurement_covariance, 1e-7)
        close(st.theta, sj.theta, 1e-7)
        close(st.covariance, sj.covariance, 1e-7)
