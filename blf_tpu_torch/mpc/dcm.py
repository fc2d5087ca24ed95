"""DCM-based walking MPC: sparse transcription + batched shared-operator solve.

Counterpart of ``blf_tpu/mpc/dcm.py``: plan the ZMP over a horizon so the
Divergent Component of Motion tracks a footstep-derived reference while the
ZMP stays inside the support polygon.

Transcription (sparse / non-condensed): decision vector

    x = [xi_1^x .. xi_N^x, xi_1^y .. xi_N^y, z_0^x .. z_{N-1}^x, z_0^y .. z_{N-1}^y]

with the exact-ZOH dynamics ``xi_{k+1} = a xi_k + (1 - a) z_k`` (a = e^{w dt})
imposed as *equality rows* of the QP rather than eliminated: condensing an
unstable flow (a > 1) stuffs powers a^N into the Hessian and wrecks its
conditioning; the sparse form keeps the Hessian diagonal and the constraint
matrix O(1), the regime the fixed-iteration ADMM of
:mod:`blf_tpu_torch.mpc.qp` is fast in. Everything of the reference module is
ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from blf_tpu_torch.models.lipm import (LIPMParams, com_trajectory_from_dcm,
                                       lipm_omega)
from blf_tpu_torch.mpc.qp import (QPSolution, SharedQPFactors, factor_shared_qp,
                                  solve_qp, solve_qp_factored)
from blf_tpu_torch.utils.profiling import trace

__all__ = ["DCMWeights", "DCMPlan", "build_dcm_qp", "solve_dcm_mpc", "SPANS"]

#: the spans of :func:`solve_dcm_mpc` (:func:`blf_tpu_torch.utils.profiling.trace`):
#: the transcription (:func:`build_dcm_qp` and the warm start's rollout), the
#: factorization and the solve (``mpc/qp.py``'s spans) and the rollout of the
#: ZMP, DCM and CoM trajectories; ``sync.h2d`` around each copy from the host
#: that waits for the device
SPANS = ("dcm.transcribe", "dcm.rollout", "sync.h2d")


class DCMWeights(NamedTuple):
    """Cost weights (all scalars)."""

    dcm_tracking: float       # Q: per-knot |xi_k - xi_ref|^2
    dcm_terminal: float       # Q_N: terminal DCM
    zmp_tracking: float       # R: |z_k - z_ref|^2
    zmp_rate: float           # R_d: |z_{k+1} - z_k|^2

    @classmethod
    def default(cls):
        return cls(dcm_tracking=10.0, dcm_terminal=100.0, zmp_tracking=0.1,
                   zmp_rate=1.0)


class DCMPlan(NamedTuple):
    """Solved plan + per-lane diagnostics."""

    zmp: torch.Tensor        # (..., N, 2)
    dcm: torch.Tensor        # (..., N+1, 2), xi_0 prepended
    com: torch.Tensor        # (..., N+1, 2)
    qp: QPSolution
    factors: Optional[SharedQPFactors] = None  # the shared factorization (shared=True)


def _zoh_gain(params: LIPMParams, dt, dtype, device) -> torch.Tensor:
    """``a = e^{w dt}`` in the working dtype."""
    w = lipm_omega(params).to(device=device, dtype=dtype)
    with trace("sync.h2d"):
        dt = torch.as_tensor(dt, dtype=dtype, device=device)
    return torch.exp(w * dt)


def build_dcm_qp(
    params: LIPMParams,
    dt,
    dcm0: torch.Tensor,        # (..., 2)
    dcm_ref: torch.Tensor,     # (..., N+1, 2) reference (index 0 unused)
    zmp_ref: torch.Tensor,     # (..., N, 2)
    poly_A: torch.Tensor,      # (..., N, F, 2) per-knot support half-spaces
    poly_b: torch.Tensor,      # (..., N, F)
    weights: Optional[DCMWeights] = None,
):
    """Assemble (P, q, A, l, u) for the sparse DCM QP (see module docstring).

    Variable layout (size 4N): ``[xi^x(N), xi^y(N), z^x(N), z^y(N)]``.
    Constraint rows (size 2N + N F): dynamics equalities then polygon rows.
    """
    if weights is None:
        weights = DCMWeights.default()
    N = zmp_ref.shape[-2]
    F = poly_A.shape[-2]
    dtype, device = zmp_ref.dtype, zmp_ref.device
    a = _zoh_gain(params, dt, dtype, device)
    new = dict(dtype=dtype, device=device)

    qw = weights.dcm_tracking
    qn = weights.dcm_terminal - weights.dcm_tracking     # extra terminal weight
    rz = weights.zmp_tracking
    rd = weights.zmp_rate

    # Hessian: diag(Q) on xi blocks; (R + D' R_d D) on z blocks.
    Qdiag = qw * torch.ones((N,), **new)
    Qdiag[-1] += qn
    eyeN = torch.eye(N, **new)
    D = eyeN[1:] - eyeN[:-1]                              # forward difference
    Hz = rz * eyeN + rd * (D.T @ D)
    P = torch.block_diag(torch.diag(Qdiag), torch.diag(Qdiag), Hz, Hz)

    # Linear term: -Q xi_ref on xi, -R z_ref on z.
    q_xi = -Qdiag[:, None] * dcm_ref[..., 1:, :]          # (..., N, 2)
    q_z = -rz * zmp_ref                                   # (..., N, 2)
    qvec = torch.cat(
        [q_xi[..., 0], q_xi[..., 1], q_z[..., 0], q_z[..., 1]], dim=-1)
    # P stays unbatched (batch rides on q/l/u).

    # Dynamics equalities, per axis: xi_k - a xi_{k-1} - (1-a) z_{k-1} = r_k
    # (xi_0 fixed: row 0 rhs = a xi_0; later rows rhs = 0).
    sub = torch.diag(torch.ones((N - 1,), **new), diagonal=-1)
    Adyn_xi = eyeN - a * sub                              # (N, N) on xi block
    Adyn_z = -(1 - a) * eyeN                              # (N, N) on z block
    zero = torch.zeros((N, N), **new)
    Adyn_x = torch.cat([Adyn_xi, zero, Adyn_z, zero], dim=-1)
    Adyn_y = torch.cat([zero, Adyn_xi, zero, Adyn_z], dim=-1)
    rhs0 = torch.zeros((N,), **new)
    with trace("sync.h2d"):
        rhs0[0] = 1.0
    bdyn_x = a * dcm0[..., 0, None] * rhs0                # (..., N)
    bdyn_y = a * dcm0[..., 1, None] * rhs0

    # Polygon rows: A_poly[k, f] . z_k <= b[k, f], one row per (k, f).
    batch = tuple(poly_A.shape[:-3])
    Az_x = torch.einsum("...kf,kn->...kfn", poly_A[..., 0], eyeN).reshape(
        batch + (N * F, N))
    Az_y = torch.einsum("...kf,kn->...kfn", poly_A[..., 1], eyeN).reshape(
        batch + (N * F, N))
    zeros_poly = torch.zeros(batch + (N * F, N), **new)
    Apoly = torch.cat([zeros_poly, zeros_poly, Az_x, Az_y], dim=-1)
    bpoly = poly_b.reshape(tuple(poly_b.shape[:-2]) + (N * F,))

    Adyn = torch.cat([Adyn_x, Adyn_y], dim=-2).broadcast_to(
        batch + (2 * N, 4 * N))
    A = torch.cat([Adyn, Apoly], dim=-2)
    bdyn = torch.cat([bdyn_x, bdyn_y], dim=-1)            # (..., 2N), dcm0 batch
    bpoly = bpoly.broadcast_to(tuple(bdyn.shape[:-1]) + (N * F,))
    u = torch.cat([bdyn, bpoly], dim=-1)
    l = torch.cat([bdyn, torch.full_like(bpoly, -torch.inf)], dim=-1)
    return P, qvec, A, l, u


_FACTOR_KEYS = ("rho", "sigma", "rho_eq_scale", "scaling_iters")


@torch.no_grad()
def solve_dcm_mpc(
    params: LIPMParams,
    dt,
    dcm0: torch.Tensor,
    com0: torch.Tensor,
    dcm_ref: torch.Tensor,
    zmp_ref: torch.Tensor,
    poly_A: torch.Tensor,
    poly_b: torch.Tensor,
    weights: Optional[DCMWeights] = None,
    *,
    iterations: int = 200,
    warm_start: Optional[torch.Tensor] = None,
    warm_start_dual: Optional[torch.Tensor] = None,
    shared: bool = False,
    reuse: Optional[SharedQPFactors] = None,
    **qp_kwargs,
) -> DCMPlan:
    """Build and solve the DCM-MPC; roll out DCM and CoM trajectories.

    Every input may carry leading batch axes. ``shared=False`` (default)
    solves every lane's own QP with :func:`blf_tpu_torch.mpc.qp.solve_qp`,
    which takes ``qp_kwargs``.

    ``shared=True`` is the fleet fast path when all lanes share references
    and polygons (batch on ``dcm0``/warm starts only): one KKT factorization,
    GEMM-shaped iterations. It requires unbatched ``poly_A``/``poly_b``.
    ``qp_kwargs`` (``backend``, ``check_every``, ``s0``, ``polish_iters``, ...)
    then pass through to :func:`blf_tpu_torch.mpc.qp.solve_qp_factored`, and
    ``rho``, ``sigma``, ``rho_eq_scale``, ``scaling_iters`` to
    :func:`blf_tpu_torch.mpc.qp.factor_shared_qp`.

    The factorization depends only on tick-invariant data. The reference
    recomputes it every call (its compiler hoists it out of a scan over
    ticks). Here a caller passes the factors of its last call as ``reuse``
    (``DCMPlan.factors``): they come back as they are where the operator and
    settings are unchanged, after a check that reads one bool back, and are
    made anew where not. Without ``reuse`` every call factors.
    """
    N = zmp_ref.shape[-2]
    with trace("dcm.transcribe"):
        P, q, A, l, u = build_dcm_qp(
            params, dt, dcm0, dcm_ref, zmp_ref, poly_A, poly_b, weights)
        x0 = None
        if warm_start is not None:
            # warm_start: previous (..., N, 2) ZMP plan; seed xi by exact rollout.
            a_ws = _zoh_gain(params, dt, warm_start.dtype, warm_start.device)
            xi = dcm0
            xis = []
            for k in range(N):
                xi = a_ws * xi + (1 - a_ws) * warm_start[..., k, :]
                xis.append(xi)
            xi_seq = torch.stack(xis, dim=-2)
            x0 = torch.cat(
                [xi_seq[..., 0], xi_seq[..., 1],
                 warm_start[..., 0], warm_start[..., 1]], dim=-1)
        if shared:
            # structural equality mask: the first 2N rows are the dynamics
            # equalities. (P, A) depend only on the shared refs/polygons; with
            # those unbatched there is one copy of each, and the batch rides
            # (q, l, u).
            if poly_A.dim() != 3 or poly_b.dim() != 2:
                raise ValueError(
                    "solve_dcm_mpc(shared=True) requires unbatched poly_A/poly_b"
                    " (lanes share one transcription); use shared=False for"
                    " per-lane polygons")
            is_eq = torch.arange(A.shape[-2], device=A.device) < 2 * N
    if shared:
        factors = factor_shared_qp(
            P, A, is_eq, reuse=reuse,
            **{k: qp_kwargs.pop(k) for k in _FACTOR_KEYS if k in qp_kwargs})
        sol = solve_qp_factored(factors, q, l, u, iterations=iterations,
                                x0=x0, y0=warm_start_dual, **qp_kwargs)
    else:
        factors = None
        sol = solve_qp(P, q, A, l, u, iterations=iterations, x0=x0,
                       y0=warm_start_dual, **qp_kwargs)
    with trace("dcm.rollout"):
        zmp = torch.stack(
            [sol.x[..., 2 * N: 3 * N], sol.x[..., 3 * N:]], dim=-1)  # (..., N, 2)

        # DCM trajectory from the QP's own xi decision variables: the dynamics
        # equality rows pin them to the rollout within the solver residual. Do
        # NOT re-roll xi+ = a xi + (1 - a) z forward: the DCM flow is unstable
        # (a > 1), so over a long horizon that recursion amplifies rounding by
        # a^T. Consequence: plan.dcm/com satisfy the DCM dynamics only up to the
        # QP residual; gate on plan.qp.converged before consuming them as
        # dynamically consistent trajectories.
        dcm_knots = torch.stack(
            [sol.x[..., 0:N], sol.x[..., N:2 * N]], dim=-1)   # (..., N, 2) = xi_{1..N}
        dcm_traj = torch.cat(
            [dcm0[..., None, :].broadcast_to(dcm_knots[..., :1, :].shape),
             dcm_knots], dim=-2)
        com_traj = com_trajectory_from_dcm(params, com0, dcm_traj, zmp, dt)
    return DCMPlan(zmp=zmp, dcm=dcm_traj, com=com_traj, qp=sol, factors=factors)
