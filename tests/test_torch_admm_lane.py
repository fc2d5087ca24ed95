"""The plain version of the fused per-lane ADMM stage (kernel K2) against

- the JAX package's Pallas kernel in interpret mode, in float32 (1e-5
  relative: the same recursion, other evaluation order inside the three
  matrix-vector products), and
- an independent numpy recursion, lane by lane, in float64 (1e-12).

On the CPU ``admm_lane_stage`` runs its plain version; the CUDA kernel itself
is held against that plain version on the card by ``chip_smoke.py`` phase
``kernels``. Layouts differ: the reference is batch-minor, ``(m, B)`` and
``(m, n, B)``; the port is lane-major, ``(B, m)`` and ``(B, m, n)``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.ops.pallas import admm_lane as jlane
from blf_tpu_torch.ops.cuda import admm_lane as tlane

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

ALPHA = 1.6


def lane_problem(B, m, n, dtype, seed=0):
    """A random stage with equality rows, one-sided rows (both signs of
    infinity) and boxed rows; K^-1 exact, from float64."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    G = rng.normal(size=(B, n, n))
    P = G @ np.swapaxes(G, -1, -2) / n + 0.1 * np.eye(n)
    rho = 10.0 ** rng.uniform(-1, 1, (B, 1)) * np.where(np.arange(m) < m // 3, 30.0, 1.0)
    K = P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    lo = rng.normal(-0.5, 0.5, (B, m))
    hi = lo + np.abs(rng.normal(0, 1, (B, m)))
    hi[:, : m // 3] = lo[:, : m // 3]                # equality rows
    lo[:, m // 3: m // 3 + 3] = -np.inf              # one-sided rows
    hi[:, m // 3 + 3: m // 3 + 5] = np.inf
    out = dict(v=rng.normal(size=(B, m)), rho=rho, A=A, Kinv=np.linalg.inv(K),
               q=rng.normal(size=(B, n)), l=lo, u=hi)
    return {k: a.astype(dtype) for k, a in out.items()}


ORDER = ("v", "rho", "A", "Kinv", "q", "l", "u")


def run_port(a, iters, dtype):
    args = [torch.as_tensor(a[k], dtype=dtype) for k in ORDER]
    v, x = tlane.admm_lane_stage(*args, iters=iters, alpha=ALPHA)
    return v.numpy(), x.numpy()


def run_pallas(a, iters):
    """Batch-minor in, lane-major out."""
    t = lambda k: jnp.asarray(np.moveaxis(a[k], 0, -1))
    v, x = jlane.admm_lane_stage(t("v"), t("rho"), t("A"), t("Kinv"), t("q"), t("l"),
                                 t("u"), iters=iters, alpha=ALPHA, interpret=True)
    return np.asarray(v).T, np.asarray(x).T


def numpy_recursion(a, iters):
    v, x = a["v"].copy(), np.zeros_like(a["q"])
    for b in range(v.shape[0]):
        for _ in range(iters):
            z = np.minimum(np.maximum(v[b], a["l"][b]), a["u"][b])
            w = a["rho"][b] * (2.0 * z - v[b])
            x[b] = a["Kinv"][b] @ (a["A"][b].T @ w - a["q"][b])
            v[b] = v[b] + ALPHA * (a["A"][b] @ x[b] - z)
    return v, x


def rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("B,m,n,iters", [(8, 18, 12, 25), (5, 30, 16, 10), (1, 18, 12, 3)])
def test_f32_matches_pallas_interpret(B, m, n, iters):
    """Ragged batches too: the reference pads its lane block, the port does not."""
    a = lane_problem(B, m, n, np.float32)
    ref_v, ref_x = run_pallas(a, iters)
    tlane.reset_counts()
    v, x = run_port(a, iters, torch.float32)
    assert tlane.reference_count() == 1 and tlane.launch_count() == 0
    assert v.dtype == np.float32 and v.shape == (B, m) and x.shape == (B, n)
    assert np.isfinite(v).all() and np.isfinite(x).all()
    assert rel(v, ref_v) < 1e-5 and rel(x, ref_x) < 1e-5


@pytest.mark.parametrize("B,m,n,iters", [(6, 18, 12, 25), (3, 86, 64, 5)])
def test_f64_matches_the_numpy_recursion(B, m, n, iters):
    a = lane_problem(B, m, n, np.float64, seed=1)
    ref_v, ref_x = numpy_recursion(a, iters)
    v, x = run_port(a, iters, torch.float64)
    np.testing.assert_allclose(v, ref_v, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x, ref_x, rtol=1e-12, atol=1e-12)


def test_infinite_bounds_clip_as_they_should():
    a = lane_problem(4, 18, 12, np.float64, seed=2)
    a["l"][:] = -np.inf
    a["u"][:] = np.inf                    # nothing clips: z = v, w = rho v
    v, x = run_port(a, 1, torch.float64)
    w = a["rho"] * a["v"]
    x_ref = np.einsum("bij,bj->bi", a["Kinv"], np.einsum("bmn,bm->bn", a["A"], w) - a["q"])
    np.testing.assert_allclose(x, x_ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        v, a["v"] + ALPHA * (np.einsum("bmn,bn->bm", a["A"], x_ref) - a["v"]),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("where", ["v", "l", "Kinv"])
def test_a_nan_lane_stays_local(where):
    a = lane_problem(5, 18, 12, np.float32, seed=3)
    clean_v, clean_x = run_port(a, 10, torch.float32)
    a[where][2].flat[0] = np.nan
    v, x = run_port(a, 10, torch.float32)
    assert not np.isfinite(v[2]).all() and not np.isfinite(x[2]).all()
    others = [0, 1, 3, 4]
    np.testing.assert_array_equal(v[others], clean_v[others])
    np.testing.assert_array_equal(x[others], clean_x[others])


def test_wrapper_checks_what_the_kernel_does_not_take():
    a = lane_problem(2, 18, 12, np.float32)
    args = [torch.as_tensor(a[k]) for k in ORDER]
    with pytest.raises(ValueError, match="iters must be"):
        tlane.admm_lane_stage(*args, iters=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tlane.admm_lane_stage(*(t.to("meta") for t in args), iters=1)
    with pytest.raises(ValueError, match="at most 32 are taken"):
        tlane.build_admm_lane(400, 300)
    with pytest.raises(ValueError, match="shared memory"):
        tlane.build_admm_lane(2000, 200)
    # the whole-body QP's lane: the exchange buffers and the staging of 32
    # operator rows; A and Kinv are registers
    assert tlane.lane_shared_bytes(86, 64) == 13952
    assert tlane.REPLACES == "blf_tpu/ops/pallas/admm_lane.py:56"


# (m, n) -> (warps, cols, rows, rows_in_registers, outs, outs_in_registers,
# staged_rows, shared_bytes), the kernel's compile-time plan
PLANS = {
    (86, 64): (8, 8, 3, 3, 2, 2, 32, 13952),     # the whole-body QP: all in registers
    (33, 5): (1, 5, 2, 2, 1, 1, 32, 1088),       # m not a multiple of 32: a padded row
    (1, 1): (1, 1, 1, 1, 1, 1, 32, 392),         # n = 1
    (52, 30): (4, 8, 2, 2, 1, 1, 32, 5760),      # 30 columns over four warps, padded to 32
    (400, 40): (5, 8, 13, 12, 2, 0, 32, 30528),  # A's last row and Kinv in shared memory
    (1, 256): (8, 32, 1, 1, 8, 2, 8, 216096),    # the largest n: staged 8 rows at a time
    (2049, 25): (4, 7, 65, 13, 1, 0, 32, 232320),  # 52 rows of A in shared memory, 128 bytes spare
}


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_lane_plan(shape):
    plan = tlane.lane_plan(*shape)
    assert tuple(plan) == PLANS[shape]
    m, n = shape
    assert plan.warps * plan.cols >= n and plan.cols <= 32 and 32 * plan.rows >= m
    assert plan.rows_in_registers * plan.cols + plan.outs_in_registers * plan.cols <= 96
    assert tlane.lane_shared_bytes(m, n) == plan.shared_bytes <= 232448


@pytest.mark.parametrize("shape,what", [((1, 257), "at most 32 are taken"),
                                        ((40000, 1), "shared memory"),
                                        ((0, 4), "m, n >= 1")])
def test_lane_plan_refuses_what_the_residency_cannot_hold(shape, what):
    with pytest.raises(ValueError, match=what):
        tlane.lane_plan(*shape)


def test_every_shape_of_the_shared_memory_design_is_taken():
    """The first design held A and Kinv in shared memory; every (m, n) it took
    is taken by the register-resident one (its plan is monotone in m, so the
    largest m at each n is checked)."""
    def first_design_bytes(m, n):
        gn, gm = max(1, 256 // n), max(1, 256 // m)
        return 4 * (m * (n + 1) + n * (n + 1) + m + 3 * n + max(gn * n, gm * m))

    n = 1
    while first_design_bytes(1, n) <= 232448:
        lo, hi = 1, 1 << 17
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if first_design_bytes(mid, n) <= 232448 else (lo, mid - 1)
        assert tlane.lane_plan(lo, n).shared_bytes <= 232448
        n += 1
    assert n == 239
