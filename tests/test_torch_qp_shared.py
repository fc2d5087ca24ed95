"""Port parity of the shared-operator QP path (``blf_tpu_torch.mpc.qp``).

The same numpy problem goes through the JAX package and the port (on
``device="cpu"``). The JAX package's own factorization is handed to the port's
solver through ``convert.factors_from_numpy``, so the iteration is compared on
identical operators: the DCM transcription is x/y-symmetric, every pencil
eigenvalue is at least doubly degenerate, and two ``eigh`` implementations
return different bases inside each eigenspace. So ``W``, ``G2`` and ``tau`` are
never compared entrywise; ``W diag(g) W'`` is.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import F32_LANE, tol

from blf_tpu.models.lipm import LIPMParams
from blf_tpu.mpc import qp as jqp
from blf_tpu.mpc.dcm import build_dcm_qp
from blf_tpu_torch.convert import factors_from_numpy, qp_solution_to_numpy
from blf_tpu_torch.mpc import qp as tqp
from blf_tpu_torch.ops.cuda import admm as stage
from test_torch_wbc_loop import run_reference

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

NP_DTYPE = np.float32 if F32_LANE else np.float64
T_DTYPE = torch.float32 if F32_LANE else torch.float64
H = 8
X_TOL = tol(1e-9, 2e-4)


def fleet_problem(B, np_dtype=NP_DTYPE, horizon=H, seed=0):
    """(P, q, A, l, u) of the stationary push-recovery fleet, as numpy."""
    jd = jnp.dtype(np_dtype)
    N = horizon
    params = LIPMParams(jnp.asarray(0.9, jd), jnp.asarray(9.81, jd))
    zr, dr = jnp.zeros((N, 2), jd), jnp.zeros((N + 1, 2), jd)
    pA = jnp.tile(jnp.asarray([[1.0, 0], [-1.0, 0], [0, 1.0], [0, -1.0]], jd),
                  (N, 1, 1))
    pb = jnp.broadcast_to(jnp.asarray([0.1, 0.1, 0.06, 0.06], jd), (N, 4))
    rng = np.random.default_rng(seed)
    dcm0 = jnp.asarray(rng.normal(0, 0.02, (B, 2)), jd)
    return tuple(np.asarray(a) for a in
                 run_reference(build_dcm_qp, params, 0.1, dcm0, dr, zr, pA, pb))


#: the fields of SharedQPFactors that the reference has too: all but the key
TENSOR_FIELDS = tuple(name for name in tqp.SharedQPFactors._fields if name != "key")


def to_t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype or T_DTYPE, device="cpu")


def is_eq_of(A, horizon=H):
    return np.arange(A.shape[0]) < 2 * horizon


class Shared:
    """One problem, the JAX factorization and its cold solution, made once."""

    _cache = {}

    @classmethod
    def get(cls):
        if not cls._cache:
            P, q, A, l, u = fleet_problem(32)
            fj = run_reference(jqp.factor_shared_qp, jnp.asarray(P), jnp.asarray(A),
                               jnp.asarray(is_eq_of(A)))
            ft = factors_from_numpy(fj, device="cpu", dtype=T_DTYPE)
            cold = run_reference(jqp.solve_qp_factored, fj, jnp.asarray(q), jnp.asarray(l),
                                 jnp.asarray(u), iterations=100)
            cls._cache.update(P=P, q=q, A=A, l=l, u=u, fj=fj, ft=ft, cold=cold)
        return cls._cache


class TestFactorization:
    def test_invariants_match_the_jax_factorization(self):
        c = Shared.get()
        fj = c["fj"]
        ft = tqp.factor_shared_qp(to_t(c["P"]), to_t(c["A"]),
                                  torch.as_tensor(is_eq_of(c["A"])))
        atol = tol(1e-11, 1e-4)
        for name in ("P_s", "A_s", "R2", "D", "E", "c", "base_rho", "sigma",
                     "P_orig", "A_orig"):
            np.testing.assert_allclose(
                getattr(ft, name).numpy(), np.asarray(getattr(fj, name)),
                atol=atol, rtol=atol, err_msg=name)
        dj = np.sort(np.asarray(fj.d))
        np.testing.assert_allclose(np.sort(ft.d.numpy()), dj,
                                   atol=tol(1e-9, 1e-3) * dj.max())
        # K(s)^-1 = W diag(1/(1+s d)) W' is basis-independent; W itself is not
        for s in (0.1, 1.0, 25.0):
            Kj = np.asarray(fj.W) @ np.diag(1 / (1 + s * np.asarray(fj.d))) \
                @ np.asarray(fj.W).T
            Kt = (ft.W @ torch.diag(1 / (1 + s * ft.d)) @ ft.W.T).numpy()
            # float32: K^-1 through a float32 eigenbasis carries cond(K) * eps
            np.testing.assert_allclose(Kt, Kj, atol=tol(1e-9, 5e-3) * np.abs(Kj).max())
        np.testing.assert_allclose((ft.A_s @ ft.W).numpy(), ft.G2.numpy(),
                                   atol=tol(1e-12, 1e-5))
        assert ft.d.min() >= 0

    def test_factors_cross_the_boundary_field_by_field(self):
        c = Shared.get()
        for name in TENSOR_FIELDS:
            np.testing.assert_array_equal(
                getattr(c["ft"], name).numpy(),
                np.asarray(getattr(c["fj"], name), NP_DTYPE), err_msg=name)
        assert c["ft"].key is None          # made elsewhere: never taken for reuse

    def test_batched_operators_are_rejected(self):
        c = Shared.get()
        with pytest.raises(ValueError, match="unbatched"):
            tqp.factor_shared_qp(to_t(c["P"])[None], to_t(c["A"]),
                                 torch.as_tensor(is_eq_of(c["A"])))


def compare(sol_t, sol_j, x_tol=X_TOL):
    out = qp_solution_to_numpy(sol_t)
    for name in ("x", "y", "z"):
        np.testing.assert_allclose(out[name], np.asarray(getattr(sol_j, name)),
                                   atol=x_tol, rtol=0, err_msg=name)
    # s moves by sqrt(r_prim / r_dual): near convergence both residuals are
    # differences of nearly equal numbers, so their ratio carries far fewer
    # digits than x does (measured 1e-6 relative in float64)
    # ... and in float32 it is rounding noise altogether: only its bounds hold
    if F32_LANE:
        assert np.all((out["rho_scale"] >= 1e-4) & (out["rho_scale"] <= 1e4))
    else:
        np.testing.assert_allclose(out["rho_scale"], np.asarray(sol_j.rho_scale),
                                   rtol=1e-5, err_msg="rho_scale")
    np.testing.assert_allclose(out["primal_residual"],
                               np.asarray(sol_j.primal_residual), atol=x_tol)
    np.testing.assert_allclose(out["dual_residual"],
                               np.asarray(sol_j.dual_residual), atol=10 * x_tol)
    np.testing.assert_allclose(out["objective"], np.asarray(sol_j.objective),
                               atol=x_tol)
    if not F32_LANE:
        np.testing.assert_array_equal(out["converged"], np.asarray(sol_j.converged))
    assert bool(out["refined"]) == bool(sol_j.refined)


# backend of the port, its counterpart in the JAX package, refine, warm, polish
CASES = [
    ("torch", "xla", None, False, 0),
    ("torch", "xla", True, True, 25),
    ("torch", "xla", False, False, 25),
    ("torch", "xla", False, True, 0),
    ("cuda", "xla", None, False, 25),
    ("cuda", "xla", None, True, 0),
]


class TestSolveFactored:
    @pytest.mark.parametrize("backend,jax_backend,refine,warm,polish", CASES)
    def test_matches_jax_on_the_same_factors(self, backend, jax_backend, refine,
                                             warm, polish):
        """The kernel backend has no float64 counterpart among the Pallas
        modes (they accumulate in float32), so in this lane it is held to the
        JAX package's unrefined XLA path, which runs the same recursion."""
        c = Shared.get()
        kw = dict(iterations=75, polish_iters=polish)
        jkw, tkw = dict(kw), dict(kw)
        if warm:
            cold = c["cold"]
            jkw.update(x0=cold.x, y0=cold.y, s0=cold.rho_scale)
            tkw.update(x0=to_t(cold.x), y0=to_t(cold.y), s0=to_t(cold.rho_scale))
        jax_refine = refine if backend == "torch" else False
        sol_j = run_reference(
            jqp.solve_qp_factored, c["fj"], jnp.asarray(c["q"]), jnp.asarray(c["l"]),
            jnp.asarray(c["u"]), backend=jax_backend, refine=jax_refine, **jkw)
        sol_t = tqp.solve_qp_factored(
            c["ft"], to_t(c["q"]), to_t(c["l"]), to_t(c["u"]),
            backend=backend, refine=refine, **tkw)
        compare(sol_t, sol_j)
        assert sol_t.x.dtype == T_DTYPE and tuple(sol_t.rho_scale.shape) == (32, 1)

    def test_f32_kernel_backend_matches_pallas_f32(self):
        """float32, batch 256 (the Pallas path's own batch gate), against the
        TPU kernel in interpret mode: 1e-5, as the JAX package holds its
        kernel to its XLA path."""
        P, q, A, l, u = fleet_problem(256, np.float32)
        fj = run_reference(jqp.factor_shared_qp, jnp.asarray(P), jnp.asarray(A),
                           jnp.asarray(is_eq_of(A)))
        ft = factors_from_numpy(fj, device="cpu", dtype=torch.float32)
        sol_j = jqp.solve_qp_factored(fj, jnp.asarray(q), jnp.asarray(l),
                                      jnp.asarray(u), iterations=50,
                                      backend="pallas_f32")
        f32 = lambda a: to_t(a, torch.float32)
        sol_t = tqp.solve_qp_factored(ft, f32(q), f32(l), f32(u), iterations=50,
                                      backend="cuda")
        np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x), atol=1e-5)
        np.testing.assert_allclose(sol_t.z.numpy(), np.asarray(sol_j.z), atol=1e-5)
        assert sol_t.x.dtype == torch.float32
        assert not bool(sol_t.refined) and not bool(sol_j.refined)
        # the flag compares a float32 residual with a tolerance it straddles
        # on the few lanes still settling: a handful may differ
        assert abs(int(sol_t.converged.sum()) - int(sol_j.converged.sum())) <= 5

    def test_kernel_backend_takes_any_batch_and_never_gives_way(self):
        """An odd batch goes through the stage wrapper, once per stage plus
        the polish, not through the plain-tensor path."""
        c = Shared.get()
        assert c["q"].ndim == 1            # the references are shared: so is q
        q, l, u = to_t(c["q"]), to_t(c["l"][:29]), to_t(c["u"][:29])
        stage.reset_counts()
        sol = tqp.solve_qp_factored(c["ft"], q, l, u, iterations=75,
                                    polish_iters=10, backend="cuda")
        assert stage.reference_count() == 3 + 1 and stage.launch_count() == 0
        assert tuple(sol.x.shape) == (29, 4 * H) and bool(torch.isfinite(sol.x).all())
        stage.reset_counts()
        tqp.solve_qp_factored(c["ft"], q, l, u, iterations=75, backend="torch")
        assert stage.reference_count() == 0

    def test_refine_on_the_kernel_backend_warns_and_is_recorded(self):
        c = Shared.get()
        args = (c["ft"], to_t(c["q"]), to_t(c["l"]), to_t(c["u"]))
        with pytest.warns(UserWarning, match="refine=True is not supported"):
            sol = tqp.solve_qp_factored(*args, iterations=25, backend="cuda",
                                        refine=True)
        assert not bool(sol.refined)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert bool(tqp.solve_qp_factored(*args, iterations=25).refined)

    @pytest.mark.parametrize("backend", ["cuda_split", "cuda_delta"])
    def test_reduced_precision_backends_raise(self, backend):
        """The bf16 modes are float32 modes: a float64 solve is refused, not
        rounded (their float32 parity: tests/test_torch_admm_stage_tc.py)."""
        c = Shared.get()
        f64 = factors_from_numpy(c["fj"], device="cpu", dtype=torch.float64)
        as64 = lambda a: to_t(a, torch.float64)
        with pytest.raises(TypeError, match="float32 only"):
            tqp.solve_qp_factored(f64, as64(c["q"]), as64(c["l"]), as64(c["u"]),
                                  backend=backend)

    def test_unknown_backend_raises(self):
        c = Shared.get()
        with pytest.raises(ValueError, match="unknown backend"):
            tqp.solve_qp_factored(c["ft"], to_t(c["q"]), to_t(c["l"]),
                                  to_t(c["u"]), backend="xla")

    def test_unbatched_and_broadcast_operands(self):
        """A single lane without a batch axis, and q shared by all lanes."""
        c = Shared.get()
        one = tqp.solve_qp_factored(c["ft"], to_t(c["q"]), to_t(c["l"][3]),
                                    to_t(c["u"][3]), iterations=50)
        assert tuple(one.x.shape) == (4 * H,) and tuple(one.converged.shape) == ()
        many = tqp.solve_qp_factored(
            c["ft"], to_t(np.broadcast_to(c["q"], (32, 4 * H))), to_t(c["l"]),
            to_t(c["u"]), iterations=50)
        np.testing.assert_allclose(many.x[3].numpy(), one.x.numpy(),
                                   atol=tol(1e-12, 1e-5))


class TestSolveShared:
    def test_end_to_end_with_the_ports_own_factorization(self):
        c = Shared.get()
        sol_j = run_reference(
            jqp.solve_qp_shared, *(jnp.asarray(c[k]) for k in ("P", "q", "A", "l", "u")),
            iterations=100)
        sol_t = tqp.solve_qp_shared(
            *(to_t(c[k]) for k in ("P", "q", "A", "l", "u")), iterations=100)
        np.testing.assert_allclose(sol_t.x.numpy(), np.asarray(sol_j.x),
                                   atol=tol(1e-7, 2e-4))
        assert int(sol_t.converged.sum()) == int(sol_j.converged.sum())
        np.testing.assert_allclose(float(sol_t.objective.mean()),
                                   float(sol_j.objective.mean()), atol=tol(1e-9, 1e-5))


class TestFloat32FactorizationIsMadeInFloat64:
    """``factor_shared_qp`` on float32 inputs: the whole body runs in float64
    and every field is cast on return, on any device, so that the CPU sees the
    code the card runs."""

    def operands(self, horizon=16):
        P, _, A, _, _ = fleet_problem(4, np.float32, horizon=horizon)
        return P, A, is_eq_of(A, horizon)

    def test_float32_fields_are_the_float64_factorization_cast_down(self):
        P, A, is_eq = self.operands()
        f32 = tqp.factor_shared_qp(to_t(P, torch.float32), to_t(A, torch.float32),
                                   torch.as_tensor(is_eq))
        f64 = tqp.factor_shared_qp(to_t(P, torch.float64), to_t(A, torch.float64),
                                   torch.as_tensor(is_eq))
        for name in TENSOR_FIELDS:
            a, b = getattr(f32, name), getattr(f64, name)
            assert a.dtype == torch.float32 and b.dtype == torch.float64, name
            assert torch.equal(a, b.to(torch.float32)), name
        assert f32.key.settings == f64.key.settings
        assert torch.equal(f32.P_orig, to_t(P, torch.float32))     # inputs come back as given

    def test_the_cast_factors_reproduce_the_float64_kkt_inverse(self):
        """``W diag(1 / (1 + d)) W'`` from the float32 fields against the
        float64 ``K(1)^-1``: 1e-5 relative (float32 rounding of W and d, times
        the products of an n = 64 contraction). A factorization made in
        float32 misses this by orders of magnitude on the card."""
        P, A, is_eq = self.operands()
        f32 = tqp.factor_shared_qp(to_t(P, torch.float32), to_t(A, torch.float32),
                                   torch.as_tensor(is_eq))
        f64 = tqp.factor_shared_qp(to_t(P, torch.float64), to_t(A, torch.float64),
                                   torch.as_tensor(is_eq))
        n = P.shape[-1]
        K = f64.P_s + f64.sigma * torch.eye(n, dtype=torch.float64) + f64.R2
        exact = torch.linalg.inv(K)
        W, d = f32.W.double(), f32.d.double()
        spectral = (W / (1.0 + d)) @ W.T
        err = float((spectral - exact).abs().max() / exact.abs().max())
        assert err < 1e-5, err

    def test_float64_inputs_are_factored_as_they_are(self):
        P, A, is_eq = self.operands(horizon=H)
        f = tqp.factor_shared_qp(to_t(P, torch.float64), to_t(A, torch.float64),
                                 torch.as_tensor(is_eq))
        assert all(getattr(f, name).dtype == torch.float64 for name in TENSOR_FIELDS)
        fj = run_reference(jqp.factor_shared_qp, jnp.asarray(P, jnp.float64),
                           jnp.asarray(A, jnp.float64), jnp.asarray(is_eq))
        np.testing.assert_allclose(f.d.numpy(), np.asarray(fj.d), rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# factor_shared_qp(reuse=...): the held factors come back only for the same inputs
# ---------------------------------------------------------------------------

SETTINGS = dict(rho=1.0, sigma=1e-6, rho_eq_scale=30.0, scaling_iters=10)


def small_operator(dtype=torch.float64, seed=0):
    """A random SPD ``P`` (8, 8), ``A`` (12, 8) with an exact zero at [0, 0],
    the first four rows equalities."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(8, 8))
    A = rng.normal(size=(12, 8))
    A[0, 0] = 0.0
    return (torch.as_tensor(L @ L.T + 0.5 * np.eye(8), dtype=dtype),
            torch.as_tensor(A, dtype=dtype), torch.arange(12) < 4)


def assert_same_factors(f, g):
    for name in TENSOR_FIELDS:
        assert torch.equal(getattr(f, name), getattr(g, name)), name
    assert f.key.layout == g.key.layout and f.key.settings == g.key.settings
    assert torch.equal(f.key.data, g.key.data)


def next_up(t, index):
    """``t`` with one entry moved to the next representable value."""
    t = t.clone()
    t[index] = torch.nextafter(t[index], torch.tensor(float("inf"), dtype=t.dtype))
    return t


def negative_zero(t, index):
    t = t.clone()
    t[index] = -0.0
    return t


#: an input or setting changed, as (P, A, is_eq, settings) -> the same
MISSES = {
    "P": lambda P, A, e, kw: (next_up(P, (2, 3)), A, e, kw),
    "A": lambda P, A, e, kw: (P, next_up(A, (5, 1)), e, kw),
    "A_negative_zero": lambda P, A, e, kw: (P, negative_zero(A, (0, 0)), e, kw),
    "is_eq": lambda P, A, e, kw: (P, A, torch.arange(12) < 5, kw),
    "rho": lambda P, A, e, kw: (P, A, e, {**kw, "rho": 2.0}),
    "sigma": lambda P, A, e, kw: (P, A, e, {**kw, "sigma": 1e-5}),
    "rho_eq_scale": lambda P, A, e, kw: (P, A, e, {**kw, "rho_eq_scale": 10.0}),
    "scaling_iters": lambda P, A, e, kw: (P, A, e, {**kw, "scaling_iters": 5}),
    "dtype": lambda P, A, e, kw: (P.float(), A.float(), e, kw),
}


class TestReuse:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                             ids=["float32", "float64"])
    def test_equal_inputs_return_the_held_factors(self, dtype):
        P, A, is_eq = small_operator(dtype)
        f = tqp.factor_shared_qp(P, A, is_eq)
        storage = lambda t: t.untyped_storage().data_ptr()
        assert storage(f.key.data) not in {storage(P), storage(A), storage(is_eq)}
        assert tqp.factor_shared_qp(P, A, is_eq, reuse=f) is f
        assert tqp.factor_shared_qp(P.clone(), A.clone(), is_eq.clone(), reuse=f,
                                    **SETTINGS) is f

    @pytest.mark.parametrize("change", list(MISSES))
    def test_another_input_or_setting_factors_anew(self, change):
        P, A, is_eq = small_operator()
        f = tqp.factor_shared_qp(P, A, is_eq, **SETTINGS)
        P2, A2, is_eq2, kw = MISSES[change](P, A, is_eq, SETTINGS)
        g = tqp.factor_shared_qp(P2, A2, is_eq2, reuse=f, **kw)
        assert g is not f
        assert_same_factors(g, tqp.factor_shared_qp(P2, A2, is_eq2, **kw))
        assert tqp.factor_shared_qp(P2, A2, is_eq2, reuse=g, **kw) is g

    @pytest.mark.parametrize("edited", ["P", "A", "is_eq"])
    def test_an_input_edited_in_place_is_a_miss(self, edited):
        """Float64 inputs: the key keeps a copy of their bytes, not the caller's tensors."""
        inputs = dict(zip(("P", "A", "is_eq"), small_operator(torch.float64)))
        f = tqp.factor_shared_qp(*inputs.values())
        held = f.key.data.clone()
        if edited == "is_eq":
            inputs["is_eq"][6] = True
        else:
            inputs[edited].mul_(2.0)
        g = tqp.factor_shared_qp(*inputs.values(), reuse=f)
        assert g is not f
        assert_same_factors(g, tqp.factor_shared_qp(*(t.clone() for t in inputs.values())))
        assert torch.equal(f.key.data, held)


def push_fleet(B=8):
    from blf_tpu_torch.convert import lipm_params_from_numpy
    from blf_tpu_torch.parallel import sweep
    from blf_tpu_torch.problems import stationary_push_recovery

    pr = stationary_push_recovery(B, H, seed=0, device="cpu", dtype=torch.float32)
    params = lipm_params_from_numpy(0.9, 9.81, device="cpu", dtype=torch.float32)
    make = lambda: sweep.make_fleet_step(params, 0.1, device="cpu", iterations=50,
                                         backend="torch")
    state = sweep.init_fleet(B, H, pr.num_constraints, [0.01, -0.01], [0.01, -0.01],
                             device="cpu", dtype=torch.float32)
    return pr, make, state


def span_counts(log):
    return {name: s["count"] for name, s in log.summary().items()}


def test_a_step_fed_a_new_operator_factors_anew():
    """The polygons change between ticks: the step's next tick is a miss, and
    gives what a fresh step gives from the same state; the tick after it, on
    the new polygons again, reuses the new factors."""
    from blf_tpu_torch.utils import profiling

    pr, make, state = push_fleet()
    step = make()
    state, _ = step(state, pr.disturbance, pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
    wider = (pr.dcm_ref, pr.zmp_ref, 0.5 * pr.poly_A, pr.poly_b)
    for reused in (False, True):
        with profiling.recording() as log:
            new_state, result = step(state, pr.disturbance, *wider)
        counts = span_counts(log)
        assert counts["sync.factor_key"] == 1
        assert counts.get("dcm.factor_reused", 0) == int(reused)
        assert counts.get("sync.eigh", 0) == int(not reused)
        fresh_state, fresh = make()(state, pr.disturbance, *wider)
        for a, b in zip(tuple(new_state) + tuple(result.stats) + result[1:],
                        tuple(fresh_state) + tuple(fresh.stats) + fresh[1:]):
            assert torch.equal(a, b)
        state = new_state


def test_a_reused_tick_opens_one_reuse_and_one_key_check():
    from blf_tpu_torch.utils import profiling

    pr, make, state = push_fleet()
    step = make()
    refs = (pr.dcm_ref, pr.zmp_ref, pr.poly_A, pr.poly_b)
    with profiling.recording() as log:
        state, _ = step(state, pr.disturbance, *refs)
    first = span_counts(log)
    assert first["sync.eigh"] == first["sync.cholesky"] == 1 and "sync.factor_key" not in first
    with profiling.recording() as log:
        step(state, pr.disturbance, *refs)
    counts = span_counts(log)
    assert counts["dcm.factor"] == counts["dcm.factor_reused"] == counts["sync.factor_key"] == 1
    assert "sync.eigh" not in counts and "sync.cholesky" not in counts
    syncs = lambda c: sum(v for k, v in c.items() if k.startswith("sync."))
    assert syncs(first) - syncs(counts) == 2       # cholesky, eigh, sigma's copy; + the key
