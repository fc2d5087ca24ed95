"""Plain reference of the shared-operator DCM-MPC solve.

Written from the algorithm's definition (OSQP's ADMM with Ruiz
equilibration and a spectral factorization shared by every lane, each lane
with its own penalty multiplier ``s``), not from the program's code, and
imports nothing of the program:

* :func:`transcribe`: the sparse DCM-MPC QP ``min 1/2 x'Px + q'x, l <= Ax
  <= u`` over ``x = [xi^x, xi^y, z^x, z^y]`` (N knots each), dynamics rows
  ``xi_k - a xi_{k-1} - (1 - a) z_{k-1} = [k = 0] a xi_0`` then one row per
  knot and support half-space;
* :func:`factor`: Ruiz scaling (10 passes), cost normalization, then
  ``K(s)^-1 = W diag(1 / (1 + s d)) W'`` from a Cholesky factor of
  ``P + sigma I`` and the eigendecomposition of the pencil, in float64 numpy
  on the host;
* :func:`solve`: the relaxed ADMM iteration in the constraint-space variable
  ``v = z + y / rho``, in stages of ``check_every`` iterations, each stage
  followed by the per-lane penalty rule (move ``s`` by the square root of
  the primal/dual residual ratio when it leaves [1/5, 5]); then x, z, y
  recovered, unscaled, and judged against ``eps_abs + eps_rel * scale``.

``precision="float64"`` is the reference. ``precision="bfloat16"`` is the
control: the same iteration in float32 with both products of every
iteration taken on bfloat16-rounded operands (float32 accumulation), the
single-pass tensor-core product that the program's two-pass delta form
guards against.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["QPSettings", "Factors", "transcribe", "lane_bounds", "factor", "solve",
           "Solution", "PRECISIONS"]

PRECISIONS = ("float64", "bfloat16")


class QPSettings(NamedTuple):
    rho: float
    sigma: float
    rho_eq_scale: float
    scaling_iters: int
    alpha: float
    eps_abs: float
    eps_rel: float
    s_min: float
    s_max: float
    check_every: int

    @classmethod
    def of(cls, config: dict) -> "QPSettings":
        q = config["qp"]
        return cls(float(q["rho"]), float(q["sigma"]), float(q["rho_eq_scale"]),
                   int(q["scaling_iters"]), float(q["alpha"]), float(q["eps_abs"]),
                   float(q["eps_rel"]), float(q["s_min"]), float(q["s_max"]),
                   int(config["check_every"]))


def zoh_gain(com_height: float, gravity: float, dt: float) -> float:
    """``a = e^{w dt}``, ``w = sqrt(g / z_c)``."""
    return float(np.exp(np.sqrt(gravity / com_height) * dt))


def transcribe(a: float, weights: dict, dcm_ref: np.ndarray, zmp_ref: np.ndarray,
               poly_A: np.ndarray, poly_b: np.ndarray):
    """The lane-shared part of the QP in float64 numpy: ``P (n, n)``, ``q
    (n,)``, ``A (m, n)``, the polygon rows' upper bounds ``b (N F,)`` and the
    equality mask. ``dcm_ref`` (N+1, 2), ``zmp_ref`` (N, 2), ``poly_A``
    (N, F, 2), ``poly_b`` (N, F)."""
    N, F = poly_A.shape[0], poly_A.shape[1]
    n, m = 4 * N, 2 * N + N * F
    qw, qN = float(weights["dcm_tracking"]), float(weights["dcm_terminal"])
    rz, rd = float(weights["zmp_tracking"]), float(weights["zmp_rate"])
    P = np.zeros((n, n))
    q = np.zeros(n)
    for axis in range(2):
        xi = slice(axis * N, (axis + 1) * N)
        z0 = 2 * N + axis * N
        qdiag = np.full(N, qw)
        qdiag[-1] = qN
        P[xi, xi] = np.diag(qdiag)
        q[xi] = -qdiag * dcm_ref[1:, axis]
        q[z0:z0 + N] = -rz * zmp_ref[:, axis]
        for k in range(N):
            P[z0 + k, z0 + k] += rz
        for k in range(N - 1):          # rate cost rd (z_{k+1} - z_k)^2
            i, j = z0 + k, z0 + k + 1
            P[i, i] += rd
            P[j, j] += rd
            P[i, j] -= rd
            P[j, i] -= rd
    A = np.zeros((m, n))
    for axis in range(2):
        for k in range(N):
            row = axis * N + k
            A[row, axis * N + k] = 1.0
            if k > 0:
                A[row, axis * N + k - 1] = -a
            A[row, 2 * N + axis * N + k] = -(1.0 - a)
    for k in range(N):
        for f in range(F):
            row = 2 * N + k * F + f
            A[row, 2 * N + k] = poly_A[k, f, 0]
            A[row, 3 * N + k] = poly_A[k, f, 1]
    b = poly_b.reshape(N * F).astype(np.float64)
    is_eq = np.arange(m) < 2 * N
    return P, q, A, b, is_eq


def lane_bounds(a: float, dcm0: torch.Tensor, N: int, b: torch.Tensor):
    """Per-lane ``(l, u)`` (B, m): the dynamics rows pinned to ``a xi_0`` on
    knot 0 of each axis and 0 elsewhere; the polygon rows ``(-inf, b]``."""
    B = dcm0.shape[0]
    dyn = torch.zeros((B, 2 * N), dtype=dcm0.dtype, device=dcm0.device)
    dyn[:, 0] = a * dcm0[:, 0]
    dyn[:, N] = a * dcm0[:, 1]
    upper = b.to(dcm0).expand(B, b.shape[0])
    return (torch.cat([dyn, torch.full_like(upper, -torch.inf)], dim=1),
            torch.cat([dyn, upper], dim=1))


class Factors(NamedTuple):
    """The shared factorization, float64 numpy, in the scaled frame."""

    P: np.ndarray
    A: np.ndarray
    D: np.ndarray       # column scaling (n,)
    E: np.ndarray       # row scaling (m,)
    c: float            # cost scaling
    rho: np.ndarray     # structural rho (m,)
    W: np.ndarray       # (n, n)
    d: np.ndarray       # (n,)
    G: np.ndarray       # A W (m, n)


def factor(P: np.ndarray, A: np.ndarray, is_eq: np.ndarray, st: QPSettings) -> Factors:
    n, m = P.shape[0], A.shape[0]
    D, E = np.ones(n), np.ones(m)
    P, A = P.copy(), A.copy()
    for _ in range(st.scaling_iters):
        col = np.maximum(np.abs(P).max(axis=0), np.abs(A).max(axis=0))
        dx = 1.0 / np.sqrt(np.where(col > 1e-12, col, 1.0))
        row = np.abs(A).max(axis=1)
        de = 1.0 / np.sqrt(np.where(row > 1e-12, row, 1.0))
        P = dx[:, None] * P * dx[None, :]
        A = de[:, None] * A * dx[None, :]
        D, E = D * dx, E * de
    c = 1.0 / max(float(np.abs(P).max(axis=0).mean()), 1e-12)
    P = c * P
    rho = np.where(is_eq, st.rho * st.rho_eq_scale, st.rho)
    R = A.T @ (rho[:, None] * A)
    L = np.linalg.cholesky(P + st.sigma * np.eye(n))
    Li = np.linalg.solve(L, np.eye(n))
    M = Li @ R @ Li.T
    d, U = np.linalg.eigh(0.5 * (M + M.T))
    W = Li.T @ U
    return Factors(P, A, D, E, c, rho, W, np.maximum(d, 0.0), A @ W)


class Solution(NamedTuple):
    x: torch.Tensor            # (B, n), original frame
    y: torch.Tensor            # (B, m)
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor
    converged: torch.Tensor    # (B,) bool
    s: torch.Tensor            # (B, 1) adapted multiplier


def _amax(t):
    return t.abs().amax(dim=-1)


def solve(fac: Factors, P_orig: np.ndarray, A_orig: np.ndarray, q: np.ndarray,
          l: torch.Tensor, u: torch.Tensor, st: QPSettings, iterations: int, *,
          x0=None, y0=None, s0=None, precision: str = "float64") -> Solution:
    """Solve every lane's QP (shared P, A, q; per-lane l, u) from the warm
    start ``(x0, y0, s0)`` (original frame; zeros and s = 1 where None)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision is one of {PRECISIONS}, not {precision!r}")
    dt = torch.float64 if precision == "float64" else torch.float32
    dev = l.device
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    P, A, W, G = T(fac.P), T(fac.A), T(fac.W), T(fac.G)
    D, E, d, rho0 = T(fac.D), T(fac.E), T(fac.d), T(fac.rho)
    c = float(fac.c)
    if precision == "bfloat16":
        rb = lambda t: t.to(torch.bfloat16).to(torch.float32)
        Gb = rb(G)
        prod_wG = lambda w: rb(w) @ Gb
        prod_tG = lambda t: rb(t) @ Gb.T
    else:
        prod_wG = lambda w: w @ G
        prod_tG = lambda t: t @ G.T
    l, u = l.to(dt), u.to(dt)
    B = l.shape[0]
    qs = (c * T(q) * D).expand(B, -1)
    lb, ub = E * l, E * u
    s = torch.ones((B, 1), dtype=dt, device=dev) if s0 is None else s0.to(dt).reshape(B, 1)
    z = torch.zeros_like(lb) if x0 is None else (x0.to(dt) / D) @ A.T
    y = torch.zeros_like(lb) if y0 is None else c * y0.to(dt) / E
    gq = qs @ W
    v = z + y / (s * rho0)
    tau = torch.zeros((B, W.shape[1]), dtype=dt, device=dev)
    n_stages = max(1, -(-iterations // st.check_every))
    for _ in range(n_stages):
        r = s * rho0
        dinv = 1.0 / (1.0 + s * d)
        for _ in range(st.check_every):
            z = torch.minimum(torch.maximum(v, lb), ub)
            tau = (prod_wG(r * (2.0 * z - v)) - gq) * dinv
            v = v + st.alpha * (prod_tG(tau) - z)
        z = torch.minimum(torch.maximum(v, lb), ub)
        y = r * (v - z)
        x = tau @ W.T
        Ax, Px, Aty = tau @ G.T, x @ P.T, y @ A
        rp = _amax(Ax - z) / torch.clamp(torch.maximum(_amax(Ax), _amax(z)), min=1e-12)
        rd = _amax(Px + qs + Aty) / torch.clamp(
            torch.maximum(torch.maximum(_amax(Px), _amax(Aty)), _amax(qs)), min=1e-12)
        ratio = torch.sqrt(rp / torch.clamp(rd, min=1e-12))[:, None]
        s_new = torch.where((ratio > 5.0) | (ratio < 0.2),
                            torch.clamp(s * ratio, st.s_min, st.s_max), s)
        v = z + (s / s_new) * (v - z)
        s = s_new
    z = torch.minimum(torch.maximum(v, lb), ub)
    y = (s * rho0) * (v - z)
    x = D * (tau @ W.T)
    y = E * y / c
    z = z / E
    Po, Ao, qo = T(P_orig), T(A_orig), T(q).expand(B, -1)
    Ax, Px, Aty = x @ Ao.T, x @ Po.T, y @ Ao
    r_prim = _amax(Ax - z)
    r_dual = _amax(Px + qo + Aty)
    prim_tol = st.eps_abs + st.eps_rel * torch.maximum(_amax(Ax), _amax(z))
    dual_tol = st.eps_abs + st.eps_rel * torch.maximum(
        torch.maximum(_amax(Px), _amax(Aty)), _amax(qo))
    converged = (r_prim < prim_tol) & (r_dual < dual_tol)
    return Solution(x, y, r_prim, r_dual, converged, s)
