"""Batched SQP trajectory optimizer (Gauss-Newton / iLQR-structured).

Counterpart of ``blf_tpu/mpc/sqp.py``; everything of it is ported:
:class:`SQPConfig` (the same fields and defaults), :class:`SQPSolution` and
:func:`solve_trajopt`. The solver is the reference's: Gauss-Newton
quadraticization of least-squares costs, an augmented-Lagrangian outer loop
for ``g(x, u, k) <= 0`` (per-constraint multipliers, a monotone penalty
ladder), an iLQR backward pass with a Levenberg term scaled with the penalty,
and a line search that rolls out every step size at once and keeps the best
by merit, never accepting an increase.

Where the reference solves one scenario and is ``vmap``-ped, this takes the
batch as leading axes: ``x0`` (..., nx), ``us_init`` (..., T, nu). The AL
rounds, the Gauss-Newton iterations and the T steps of the rollout, the
backward pass and the forward pass are Python loops; everything else is
batched:

- every knot's derivatives come from one forward-mode pass
  (``torch.func.jvp``) over an identity basis that rides a new leading axis
  (the reference's seven ``jax.jacfwd`` calls a knot); the user's callables
  must therefore broadcast over leading axes: ``x`` (..., nx), ``u`` (...,
  nu) and ``k`` an integer tensor that broadcasts against those axes (its
  shape is (T, 1, ...) on a whole trajectory and (1,) within a step), each
  returning (..., n);
- the step sizes ride a leading axis of the forward pass, and each lane
  picks its own step on the device (``argmin``, then a gather; the first
  minimum on ties, as ``jnp.argmin``);
- the backward step carries the value function as one augmented matrix
  ``[[c, Vx'], [Vx, Vxx]]`` and each knot's data as ``[[0, l'], [l, L]]``
  with ``z = (1, x, u)``, so that one product pair gives ``Qxx``, ``Qux``,
  ``Quu``, ``Qx`` and ``Qu``, and one solve both the feedback and the
  feedforward gain. The arithmetic is the reference's term for term.

Nothing in the solve waits on the device: solves are ``solve_ex``, the
penalty ladder is host arithmetic (it does not depend on the data), and no
``.item()``, boolean mask or Python branch reads a tensor.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as tnf

from blf_tpu_torch.mpc.riccati import parallel_value_general
from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.utils.profiling import trace

__all__ = ["SQPConfig", "SQPSolution", "solve_trajopt", "PARTS"]

#: the parts of a Gauss-Newton iteration, each a span ``sqp.<part>``
#: (:func:`blf_tpu_torch.utils.profiling.trace`): the derivative pass, the
#: backward pass (values and gains), the forward pass of every step size, and
#: the merits (candidates, selection, AL update)
PARTS = ("derivatives", "backward", "forward", "merit")


class SQPConfig(NamedTuple):
    """Fixed-budget solver knobs."""

    iterations: int = 12            # GN/iLQR iterations per AL round
    al_iterations: int = 4          # augmented-Lagrangian rounds
    penalty_init: float = 10.0      # initial AL penalty rho
    penalty_scale: float = 10.0     # rho multiplier per AL round
    penalty_max: float = 1e8
    regularization: float = 1e-8    # Levenberg term on Quu
    line_search_alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1, 0.03, 0.0)
    constraint_tol: float = 1e-6    # feasibility for `converged`
    step_tol: float = 1e-8          # |merit decrease| for `converged`
    parallel_backward: bool = False  # O(log T) associative-scan value pass
    #   (blf_tpu_torch.mpc.riccati.parallel_value_general) instead of the O(T)
    #   sequential Riccati recursion; the same gains to rounding


class SQPSolution(NamedTuple):
    states: torch.Tensor            # (..., T+1, nx)
    controls: torch.Tensor          # (..., T, nu)
    cost: torch.Tensor              # (...,) sum 1/2 |r|^2 (+ terminal), no AL terms
    max_violation: torch.Tensor     # (...,) max(0, g) over all knots
    multipliers: torch.Tensor       # (..., T, ng) final AL multipliers
    terminal_multipliers: torch.Tensor  # (..., ngT)
    converged: torch.Tensor         # (...,) bool: feasible & stalled step
    merit_decrease: torch.Tensor    # (...,) last accepted merit improvement
    gain_norm: torch.Tensor         # (...,) |feedforward|_inf at the last iterate


def _no_ineq(x, u, k):
    return x.new_zeros(x.shape[:-1] + (0,))


def _no_term_ineq(x):
    return x.new_zeros(x.shape[:-1] + (0,))


def _augment(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``[[0, v'], [v, M]]`` for v (..., n), M (..., n, n)."""
    out = tnf.pad(M, (1, 0, 1, 0))
    out[..., 1:, 0] = v
    out[..., 0, 1:] = v
    return out


def _jacobian_basis(D: int, lead: Tuple[int, ...], sizes, dtype, device):
    """The identity basis over D input directions, split by ``sizes``, each
    piece (D, *lead, size): the tangents of one ``jvp`` a Jacobian."""
    eye = torch.eye(D, dtype=dtype, device=device)
    out, at = [], 0
    for n in sizes:
        piece = eye[:, at:at + n].reshape((D,) + (1,) * len(lead) + (n,))
        out.append(piece.expand((D,) + lead + (n,)).contiguous())
        at += n
    return tuple(out)


def _q_gains(Lh, Zh, Vh, nx: int):
    """One backward step, batched over any leading axes: ``Qh = Lh + Zh'
    Vh Zh`` with ``z = (1, x, u)``, the gains ``[kff | K]`` and the new
    augmented value ``[[c, Vx'], [Vx, Vxx]]`` (symmetrized, as the
    reference does)."""
    Qh = Lh + Zh.transpose(-1, -2) @ (Vh @ Zh)
    Qu = Qh[..., 1 + nx:, :]                      # [Qu | Qux | Quu]
    Quu = Qu[..., 1 + nx:]
    gains = torch.linalg.solve_ex(Quu, Qu)[0][..., :1 + nx]    # [kff | K]
    Qu_h = Qu[..., :1 + nx]                       # [Qu | Qux]
    V = (Qh[..., :1 + nx, :1 + nx] + gains.transpose(-1, -2) @ (Quu @ gains - Qu_h)
         - Qu_h.transpose(-1, -2) @ gains)
    return gains, 0.5 * (V + V.transpose(-1, -2))


@f32_matmuls
def solve_trajopt(
    dynamics: Callable,             # f(x, u, k) -> x_next
    running_residuals: Callable,    # r(x, u, k) -> (..., nr)   cost 1/2 |r|^2
    terminal_residuals: Callable,   # rT(x) -> (..., nrT)
    x0: torch.Tensor,               # (..., nx)
    us_init: torch.Tensor,          # (..., T, nu)
    *,
    inequality: Optional[Callable] = None,          # g(x, u, k) <= 0, (..., ng)
    terminal_inequality: Optional[Callable] = None,  # gT(x) <= 0, (..., ngT)
    config: SQPConfig = SQPConfig(),
) -> SQPSolution:
    """Solve ``min sum 1/2|r(x,u,k)|^2 + 1/2|rT(x_T)|^2  s.t. x+ = f(x,u,k),
    g <= 0`` for every lane of the batch; see the module docstring. Every
    field of the result carries the batch of ``x0``."""
    ineq = inequality or _no_ineq
    term_ineq = terminal_inequality or _no_term_ineq
    batch, nx = tuple(x0.shape[:-1]), x0.shape[-1]
    T, nu = us_init.shape[-2:]
    dtype, device = us_init.dtype, us_init.device
    x0 = x0.reshape(-1, nx)
    B = x0.shape[0]
    us0 = us_init.expand(batch + (T, nu)).reshape(B, T, nu).transpose(0, 1)   # time-major
    D = nx + nu
    ks = torch.arange(T, device=device)
    k_traj = ks[:, None]                              # (T, 1): against (T, B) axes
    k_step = [ks[k:k + 1] for k in range(T)]          # (1,): against (B,) or (A, B)
    alphas = torch.tensor(config.line_search_alphas, dtype=dtype).to(device, non_blocking=True)
    n_alpha = alphas.shape[0]
    ng = ineq(x0, us0[0], k_step[0]).shape[-1]        # one call on the first knot
    ngT = term_ineq(x0).shape[-1]
    tangents = _jacobian_basis(D, (T, B), (nx, nu), dtype, device)
    tangents_T = _jacobian_basis(nx, (B,), (nx,), dtype, device)

    def rollout(us):
        x, xs = x0, [x0]
        for k in range(T):
            x = dynamics(x, us[k], k_step[k])
            xs.append(x)
        return torch.stack(xs)

    def merit(xs, us, mu, muT, rho):
        """AL merit ``cost + sum psi(g, mu, rho)``, ``psi = (max(0, mu + rho
        g)^2 - mu^2) / 2 rho``, of trajectories (T+1, ..., nx), (T, ..., nu)
        with any lane axes after time; with the cost and the violation."""
        k = ks.reshape((T,) + (1,) * (xs.dim() - 2))
        r = running_residuals(xs[:-1], us, k)
        rT = terminal_residuals(xs[-1])
        cost = 0.5 * ((r * r).sum((0, -1)) + (rT * rT).sum(-1))
        al = torch.zeros_like(cost)
        viol = torch.zeros_like(cost)
        if ng:
            g = ineq(xs[:-1], us, k)
            w = torch.clamp(mu + rho * g, min=0.0)
            al = al + (w * w - mu * mu).sum((0, -1))
            viol = torch.clamp(g, min=0.0).amax((0, -1))
        if ngT:
            gT = term_ineq(xs[-1])
            wT = torch.clamp(muT + rho * gT, min=0.0)
            al = al + (wT * wT - muT * muT).sum(-1)
            viol = torch.maximum(viol, torch.clamp(gT, min=0.0).amax(-1))
        return cost + al / (2.0 * rho), cost, viol

    def stage(x, u):
        out = (running_residuals(x, u, k_traj), dynamics(x, u, k_traj))
        return out + (ineq(x, u, k_traj),) if ng else out

    def terminal(x):
        out = (terminal_residuals(x),)
        return out + (term_ineq(x),) if ngT else out

    def derivatives(xs, us, mu, muT, rho, reg):
        """Every knot's augmented data ``Lh`` (T, B, 1+D, 1+D) with the
        Levenberg term in its uu block, the augmented dynamics ``Zh`` (T, B,
        1+nx, 1+D), and the terminal value ``Vh`` (B, 1+nx, 1+nx)."""
        primals = (xs[:-1].expand((D,) + xs[:-1].shape).contiguous(),
                   us.expand((D,) + us.shape).contiguous())
        values, columns = torch.func.jvp(stage, primals, tangents)
        r = values[0][0]
        Jz = columns[0].movedim(0, -1)                       # (T, B, nr, D)
        lz = (Jz.transpose(-1, -2) @ r[..., None])[..., 0]   # [lx; lu]
        Lzz = Jz.transpose(-1, -2) @ Jz                      # [[lxx, lxu], [lux, luu]]
        if ng:
            Gz = columns[2].movedim(0, -1)
            w = torch.clamp(mu + rho * values[2][0], min=0.0)
            act = (w > 0.0).to(dtype)
            lz = lz + (Gz.transpose(-1, -2) @ w[..., None])[..., 0]
            Lzz = Lzz + rho * (Gz.transpose(-1, -2) @ (act[..., None] * Gz))
        Lzz[..., nx:, nx:] += reg * torch.eye(nu, dtype=dtype, device=device)
        Zh = tnf.pad(columns[1].movedim(0, -1), (1, 0, 1, 0))  # [[1, 0], [0, A B]]
        Zh[..., 0, 0] = 1.0

        xT = xs[-1].expand((nx,) + xs[-1].shape).contiguous()
        values_T, columns_T = torch.func.jvp(terminal, (xT,), tangents_T)
        rT = values_T[0][0]
        JT = columns_T[0].movedim(0, -1)
        Vx = (JT.transpose(-1, -2) @ rT[..., None])[..., 0]
        Vxx = JT.transpose(-1, -2) @ JT
        if ngT:
            GT = columns_T[1].movedim(0, -1)
            wT = torch.clamp(muT + rho * values_T[1][0], min=0.0)
            actT = (wT > 0.0).to(dtype)
            Vx = Vx + (GT.transpose(-1, -2) @ wT[..., None])[..., 0]
            Vxx = Vxx + rho * (GT.transpose(-1, -2) @ (actT[..., None] * GT))
        return _augment(lz, Lzz), Zh, _augment(Vx, Vxx)

    def backward(Lh, Zh, Vh):
        """Gains ``[kff | K]`` (T, B, nu, 1+nx)."""
        if config.parallel_backward:
            # the O(log T) value pass (Lh's uu block carries the Levenberg
            # term, so it is in luu there and in Quu below, as in the
            # reference), then every knot's gains at once
            lane = lambda t: t.transpose(0, 1)                 # (B, T, ...)
            x_, u_ = slice(1, 1 + nx), slice(1 + nx, None)
            Vxs, Vxxs = parallel_value_general(
                lane(Zh[..., 1:, x_]), lane(Zh[..., 1:, u_]), lane(Lh[..., x_, 0]),
                lane(Lh[..., u_, 0]), lane(Lh[..., x_, x_]), lane(Lh[..., u_, u_]),
                lane(Lh[..., u_, x_]), Vh[..., 1:, 0], Vh[..., 1:, 1:])
            V_next = _augment(lane(Vxs[:, 1:]), lane(Vxxs[:, 1:]))
            return _q_gains(Lh, Zh, V_next, nx)[0]
        gains = [None] * T
        for k in range(T - 1, -1, -1):
            gains[k], Vh = _q_gains(Lh[k], Zh[k], Vh, nx)
        return torch.stack(gains)

    def forward(xs_nom, us_nom, gains):
        """Rollouts of every step size: (T+1, A, B, nx), (T, A, B, nu)."""
        u_base = us_nom[:, None] - alphas[:, None, None] * gains[:, None, :, :, 0]
        K = gains[..., 1:]
        x = x0.expand(n_alpha, B, nx)
        xs, us = [x], []
        for k in range(T):
            u = u_base[k] - ((x - xs_nom[k])[..., None, :] * K[k]).sum(-1)
            x = dynamics(x, u, k_step[k])
            xs.append(x)
            us.append(u)
        return torch.stack(xs), torch.stack(us)

    def select(cand, best):
        index = best.reshape((1, 1, B) + (1,) * (cand.dim() - 3))
        return cand.gather(1, index.expand((cand.shape[0], 1) + cand.shape[2:]))[:, 0]

    xs, us = rollout(us0), us0
    mu = torch.zeros((T, B, ng), dtype=dtype, device=device)
    muT = torch.zeros((B, ngT), dtype=dtype, device=device)
    rho = float(config.penalty_init)
    decrease = gain = None
    for _ in range(config.al_iterations):
        # Levenberg term scaled with the AL penalty (the reference's reasons:
        # the active-constraint block of Quu grows with rho)
        reg = config.regularization * max(1.0, rho)
        with trace("sqp.merit"):
            m_prev = merit(xs, us, mu, muT, rho)[0]
        for it in range(config.iterations):
            with trace("sqp.derivatives"):
                Lh, Zh, Vh = derivatives(xs, us, mu, muT, rho, reg)
            with trace("sqp.backward"):
                gains = backward(Lh, Zh, Vh)
            with trace("sqp.forward"):
                xs_cand, us_cand = forward(xs, us, gains)
            with trace("sqp.merit"):
                m_cand = merit(xs_cand, us_cand, mu[:, None], muT, rho)[0]
                m_cand = torch.where(torch.isfinite(m_cand), m_cand,
                                     torch.full_like(m_cand, float("inf")))
                best = torch.argmin(m_cand, 0)
                m_new = m_cand.gather(0, best[None])[0]
                # never accept an increase over the incumbent (alpha = 0 is in
                # the set, so this only triggers on numerically tied candidates)
                take = m_new <= m_prev
                xs = torch.where(take[:, None], select(xs_cand, best), xs)
                us = torch.where(take[:, None], select(us_cand, best), us)
                m_new = torch.where(take, m_new, m_prev)
                if it == config.iterations - 1:
                    decrease = m_prev - m_new
                    gain = gains[..., 0].abs().amax((0, -1))
                m_prev = m_new
        with trace("sqp.merit"):
            if ng:
                mu = torch.clamp(mu + rho * ineq(xs[:-1], us, k_traj), min=0.0)
            if ngT:
                muT = torch.clamp(muT + rho * term_ineq(xs[-1]), min=0.0)
            rho = min(rho * config.penalty_scale, config.penalty_max)

    _, cost, viol = merit(xs, us, mu, muT, rho)
    converged = (viol <= config.constraint_tol) & (decrease.abs() <= config.step_tol)
    lanes = lambda t: t.reshape(batch + t.shape[1:])
    return SQPSolution(
        states=lanes(xs.transpose(0, 1)), controls=lanes(us.transpose(0, 1)),
        cost=lanes(cost), max_violation=lanes(viol),
        multipliers=lanes(mu.transpose(0, 1)), terminal_multipliers=lanes(muT),
        converged=lanes(converged), merit_decrease=lanes(decrease), gain_norm=lanes(gain))
