"""Riccati/LQR solvers: the sequential backward pass and the parallel-in-time
associative scan.

Counterpart of ``blf_tpu/mpc/riccati.py``. Ported: :class:`LQRSolution`,
:func:`solve_lqr` in both forms (``parallel=False``: the backward Riccati
recursion, O(T) depth; ``parallel=True``: the Saerkkae & Garcia-Fernandez
elements composed by a log-depth suffix scan) and
:func:`parallel_value_general` (the SQP's subproblem, with cross and linear
terms). Not yet ported: ``solve_lqr_sharded`` (the horizon sharded over
devices), which waits for the multi-device slice (ROADMAP.md 4.5) and raises
``NotImplementedError`` until then.

Problem: ``min sum_k 1/2 x_k' Q_k x_k + 1/2 u_k' R_k u_k + 1/2 x_T' Q_T x_T``
subject to ``x_{k+1} = F_k x_k + L_k u_k + c_k``.

Where the reference is single-problem and ``vmap``-ped, every function here
takes leading batch axes: ``Fs`` is (..., T, nx, nx), ``cs`` (..., T, nx),
``QT`` (..., nx, nx), ``x0`` (..., nx), and the batch shapes broadcast. The
time axis is the one before the matrix (or vector) axes; the scans move it
to the front. Solves and inverses are the library's ``_ex`` forms, which
leave a singular lane's values to that lane and never wait on the device
(``jnp.linalg`` raises nothing either).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.ops.scan import associative_scan

__all__ = ["LQRSolution", "solve_lqr", "solve_lqr_sharded", "parallel_value_general"]

Element = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class LQRSolution(NamedTuple):
    gains: torch.Tensor           # (..., T, nu, nx) feedback K_k (u = -K x - k_ff)
    feedforward: torch.Tensor     # (..., T, nu)
    value_matrices: torch.Tensor  # (..., T+1, nx, nx) Riccati P_k
    value_vectors: torch.Tensor   # (..., T+1, nx) linear value terms p_k
    states: torch.Tensor          # (..., T+1, nx) optimal rollout from x0
    controls: torch.Tensor        # (..., T, nu)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (a @ v[..., None])[..., 0]


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^-1 b`` for a (..., n, n) and b (..., n, k), batch broadcast."""
    return torch.linalg.solve_ex(a, b)[0]


def _inv(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(a)[0]


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _sequential_value(Fs, cs, Ls, Qs, Rs, QT):
    """Backward Riccati recursion: ``(K, kff, P, p)`` with the time axis
    before the matrix axes; P and p have T+1 knots, the terminal last."""
    T = Fs.shape[-3]
    P, p = QT, torch.zeros_like(QT[..., 0])
    Ks, kffs, Ps, ps = [None] * T, [None] * T, [None] * T, [None] * T
    for k in range(T - 1, -1, -1):
        F, c, L, Q, R = Fs[..., k, :, :], cs[..., k, :], Ls[..., k, :, :], Qs[..., k, :, :], \
            Rs[..., k, :, :]
        # u* = -(R + L'PL)^-1 L'(P(Fx + c) + p)
        H = R + _t(L) @ (P @ L)
        G = _t(L) @ (P @ F)
        Pc_p = _mv(P, c) + p
        g = _mv(_t(L), Pc_p)
        K = _solve(H, G)
        kff = _solve(H, g[..., None])[..., 0]
        FKL = F - L @ K
        P, p = Q + _t(F) @ (P @ FKL), _mv(_t(FKL), Pc_p)
        Ks[k], kffs[k], Ps[k], ps[k] = K, kff, P, p
    Ps.append(QT.expand(Ps[0].shape))
    ps.append(torch.zeros_like(ps[0]))
    return (torch.stack(Ks, -3), torch.stack(kffs, -2), torch.stack(Ps, -3),
            torch.stack(ps, -2))


def _value_elements(Fs, cs, Ls, Qs, Rs) -> Element:
    """Per-interval elements e = (A, b, C, eta, J), time leading."""
    Cs = Ls @ _inv(Rs) @ _t(Ls)
    return Fs, cs, Cs, torch.zeros_like(cs), Qs


def _terminal_element(QT) -> Element:
    zeros = torch.zeros_like(QT)
    return zeros, zeros[..., 0], zeros, zeros[..., 0], QT


def _combine_value(e_ij: Element, e_jk: Element) -> Element:
    """Compose two conditional-value elements, earlier (i -> j) first.
    Associative; works on any matching leading batch axes."""
    A1, b1, C1, eta1, J1 = e_ij
    A2, b2, C2, eta2, J2 = e_jk
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    D = _inv(eye + C1 @ J2)
    Dt = _inv(eye + J2 @ C1)
    A = A2 @ (D @ A1)
    b = _mv(A2, _mv(D, b1 + _mv(C1, eta2))) + b2
    C = A2 @ (D @ (C1 @ _t(A2))) + C2
    eta = _mv(_t(A1), _mv(Dt, eta2 - _mv(J2, b1))) + eta1
    J = _t(A1) @ (Dt @ (J2 @ A1)) + J1
    return A, b, C, eta, J


def _suffix_scan(elems: Element) -> Element:
    """``out[k] = e_k . e_{k+1} . ... . e_last`` along axis 0."""
    return associative_scan(_combine_value, elems, reverse=True)


#: core (matrix or vector) axes of each slot of an element
_CORE = (2, 1, 2, 1, 2)


def _time_first(elems, term) -> Element:
    """Elements (..., T, core) and the terminal (..., core) as (T+1, ..., core)."""
    out = []
    for e, t, core in zip(elems, term, _CORE):
        e = e.movedim(e.dim() - core - 1, 0)
        shape = torch.broadcast_shapes(e.shape[1:], t.shape)
        out.append(torch.cat([e.expand((e.shape[0],) + shape), t.expand(shape)[None]], 0))
    return tuple(out)


def _gains(F, c, L, R, P_next, p_next):
    """One-step argmin against V_{k+1}: feedback K and feedforward kff."""
    H = R + _t(L) @ (P_next @ L)
    K = _solve(H, _t(L) @ (P_next @ F))
    g = _mv(_t(L), _mv(P_next, c) + p_next)
    kff = _solve(H, g[..., None])[..., 0]
    return K, kff


def _parallel_value(Fs, cs, Ls, Qs, Rs, QT):
    """Associative-scan Riccati: every suffix value function in O(log T)
    depth, then every knot's gains at once."""
    elems = _time_first(_value_elements(Fs, cs, Ls, Qs, Rs), _terminal_element(QT))
    _, _, _, etas, Js = _suffix_scan(elems)
    # value at knot k: V_k(x) = 1/2 x' J_k x - eta_k' x (+ const)
    Ps, ps = Js.movedim(0, -3), (-etas).movedim(0, -2)
    Ks, kffs = _gains(Fs, cs, Ls, Rs, Ps[..., 1:, :, :], ps[..., 1:, :])
    return Ks, kffs, Ps, ps


@f32_matmuls
def solve_lqr(Fs, cs, Ls, Qs, Rs, QT, x0, *, parallel: bool = False) -> LQRSolution:
    """Finite-horizon time-varying LQR; see the module docstring.

    ``Fs`` (..., T, nx, nx), ``cs`` (..., T, nx), ``Ls`` (..., T, nx, nu),
    ``Qs`` (..., T, nx, nx) state costs at knots 0..T-1, ``Rs`` (..., T, nu,
    nu), ``QT`` (..., nx, nx) terminal cost, ``x0`` (..., nx); the batch
    shapes broadcast, and every field of the result has the broadcast batch.
    ``parallel=True`` uses the O(log T)-depth associative scan (the same
    result to rounding)."""
    if parallel:
        Ks, kffs, Ps, ps = _parallel_value(Fs, cs, Ls, Qs, Rs, QT)
    else:
        Ks, kffs, Ps, ps = _sequential_value(Fs, cs, Ls, Qs, Rs, QT)
    T = Fs.shape[-3]
    x, xs, us = x0, [x0], []
    for k in range(T):
        u = -(_mv(Ks[..., k, :, :], x) + kffs[..., k, :])
        x = _mv(Fs[..., k, :, :], x) + _mv(Ls[..., k, :, :], u) + cs[..., k, :]
        xs.append(x)
        us.append(u)
    batch = torch.broadcast_shapes(Ks.shape[:-3], x.shape[:-1])
    xs = torch.stack([v.expand(batch + v.shape[-1:]) for v in xs], -2)
    us = torch.stack(us, -2)
    grow = lambda t, core: t.expand(batch + t.shape[t.dim() - core:])
    return LQRSolution(gains=grow(Ks, 3), feedforward=grow(kffs, 2), value_matrices=grow(Ps, 3),
                       value_vectors=grow(ps, 2), states=xs, controls=grow(us, 2))


def solve_lqr_sharded(*args, **kwargs):
    """The horizon sharded over devices: not ported yet; it waits for the
    multi-device slice (ROADMAP.md 4.5)."""
    raise NotImplementedError(
        "solve_lqr_sharded is not ported yet: it waits for the multi-device slice"
        " (ROADMAP.md 4.5); solve_lqr(parallel=True) runs the same scan on one device")


@f32_matmuls
def parallel_value_general(As, Bs, lx, lu, lxx, luu, lux, VxT, VxxT):
    """O(log T)-depth value functions of the SQP's quadratic subproblem.

    The SQP backward pass (:mod:`blf_tpu_torch.mpc.sqp`) has cross terms
    (``lux``) and linear terms (``lx``/``lu``), which the plain elements of
    :func:`solve_lqr` do not carry. Completing the square in the control,
    ``u = v - luu^-1 (lu + lux x)``, gives each stage the canonical affine
    form whose elements compose associatively (the eta slot carries the
    linear state cost):

        F~ = A - B luu^-1 lux        c~ = -B luu^-1 lu       L~ = B
        Q~ = lxx - lux' luu^-1 lux   q~ = lx - lux' luu^-1 lu  R~ = luu

    ``As`` (..., T, nx, nx), ``Bs`` (..., T, nx, nu), ``lx`` (..., T, nx),
    ``lu`` (..., T, nu), ``lxx`` (..., T, nx, nx), ``luu`` (..., T, nu, nu),
    ``lux`` (..., T, nu, nx), ``VxT`` (..., nx), ``VxxT`` (..., nx, nx).
    Returns ``(Vxs, Vxxs)``, (..., T+1, nx) and (..., T+1, nx, nx): the value
    function's gradient and Hessian at every knot, the sequential backward
    recursion's to rounding. The composed maps carry products of the
    open-loop ``A``: on unstable dynamics (the DCM flow) float32 holds the
    sequential pass only up to T ~ 24; longer horizons need float64.
    """
    luu_lu = _solve(luu, lu[..., None])[..., 0]
    luu_lux = _solve(luu, lux)
    luxT = _t(lux)
    Ft = As - Bs @ luu_lux
    ct = -_mv(Bs, luu_lu)
    Qt = lxx - luxT @ luu_lux
    Qt = 0.5 * (Qt + _t(Qt))
    qt = lx - _mv(luxT, luu_lu)
    Cs = Bs @ _inv(luu) @ _t(Bs)
    zeros = torch.zeros_like(VxxT)
    term = (zeros, zeros[..., 0], zeros, -VxT, VxxT)
    _, _, _, etas, Js = _suffix_scan(_time_first((Ft, ct, Cs, -qt, Qt), term))
    return (-etas).movedim(0, -2), Js.movedim(0, -3)
