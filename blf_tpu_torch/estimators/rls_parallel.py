"""Parallel-in-time RLS: the exponentially weighted information filter as an
associative scan.

Counterpart of ``blf_tpu/estimators/rls_parallel.py``; everything of it is
ported: ``rls_leaf_elements``, ``rls_combine``, ``rls_parallel``,
``rls_fit`` and ``rls_parallel_sharded`` (the stream sharded over the ranks
of a mesh axis, on ``torch.distributed``).

Math. With forgetting factor lam, prior (theta0, P0), regressors A_t and
measurements y_t, the sequential RLS estimate after t steps is

    Lam_t = lam^t P0^-1 + sum_{s<=t} lam^(t-s) A_s' R^-1 A_s
    b_t   = lam^t P0^-1 theta0 + sum_{s<=t} lam^(t-s) A_s' R^-1 y_s
    theta_t = Lam_t^-1 b_t,   P_t = Lam_t^-1

and the weighted prefix sums compose associatively (not commutatively):

    (Lam_l, b_l, w_l) + (Lam_r, b_r, w_r) = (w_r Lam_l + Lam_r, w_r b_l + b_r, w_l w_r)

with leaf elements (A_t' R^-1 A_t, A_t' R^-1 y_t, lam), scanned in log depth by
:func:`blf_tpu_torch.ops.scan.associative_scan` (the recursion of
``jax.lax.associative_scan`` in torch ops). All functions broadcast over leading batch axes of
``regressors`` / ``measurements`` after the time axis, so a fleet of
estimators runs as one batched program.
"""

from __future__ import annotations

from typing import Tuple

import torch

from blf_tpu_torch.estimators.rls import RLSParams, RLSState
from blf_tpu_torch.ops.linalg import solve_psd
from blf_tpu_torch.ops.scan import associative_scan
from blf_tpu_torch.ops.precision import f32_matmuls
from blf_tpu_torch.parallel.collectives import all_gather_tree
from blf_tpu_torch.parallel.mesh import axis_index, axis_size, gather_batch

__all__ = ["rls_leaf_elements", "rls_combine", "associative_scan", "rls_parallel",
           "rls_fit", "rls_parallel_sharded"]

Aggregate = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@f32_matmuls
def rls_leaf_elements(params: RLSParams, regressors: torch.Tensor,
                      measurements: torch.Tensor) -> Aggregate:
    """Per-step information increments ``(A' R^-1 A, A' R^-1 y, lam)``.

    ``regressors``: ``(T, ..., m, p)``; ``measurements``: ``(T, ..., m)``.
    ``R^-1 A`` is a PSD solve with the m x m covariance (its inverse is never
    supplied), the covariance broadcast against the regressors.
    """
    RinvA = solve_psd(params.measurement_covariance, regressors)       # (T, ..., m, p)
    Lam = regressors.transpose(-1, -2) @ RinvA                          # (T, ..., p, p)
    b = torch.einsum("...mp,...m->...p", RinvA, measurements)           # (T, ..., p)
    w = torch.as_tensor(params.lam, dtype=Lam.dtype, device=Lam.device).expand(
        Lam.shape[:-2])                                                 # (T, ...)
    return Lam, b, w


def rls_combine(left: Aggregate, right: Aggregate) -> Aggregate:
    """Associative combine of weighted information aggregates; ``left`` is
    the earlier stretch of the stream."""
    Lam_l, b_l, w_l = left
    Lam_r, b_r, w_r = right
    return (w_r[..., None, None] * Lam_l + Lam_r,
            w_r[..., None] * b_l + b_r,
            w_l * w_r)


@f32_matmuls
def _states_from_aggregates(state0: RLSState, Lam, b, w) -> RLSState:
    """Fold the prior through the aggregates and invert to covariance form."""
    P0, theta0 = state0.covariance, state0.theta
    eye = torch.eye(P0.shape[-1], dtype=P0.dtype, device=P0.device)
    prior_info = solve_psd(P0, eye.expand(P0.shape))
    Lam_t = w[..., None, None] * prior_info + Lam
    b_t = w[..., None] * torch.einsum("...ij,...j->...i", prior_info, theta0) + b
    P_t = solve_psd(Lam_t, eye.expand(Lam_t.shape))
    P_t = 0.5 * (P_t + P_t.transpose(-1, -2))
    theta_t = torch.einsum("...ij,...j->...i", P_t, b_t)
    return RLSState(theta_t, P_t)


def rls_parallel(params: RLSParams, state0: RLSState, regressors: torch.Tensor,
                 measurements: torch.Tensor) -> Tuple[RLSState, torch.Tensor]:
    """All T posterior states in O(log T) depth: ``(final_state, thetas)``
    with ``thetas[t]`` the estimate after step t, as ``rls_scan`` gives it."""
    leaves = rls_leaf_elements(params, regressors, measurements)
    Lam, b, w = associative_scan(rls_combine, leaves)
    states = _states_from_aggregates(state0, Lam, b, w)
    return RLSState(states.theta[-1], states.covariance[-1]), states.theta


def rls_fit(params: RLSParams, state0: RLSState, regressors: torch.Tensor,
            measurements: torch.Tensor) -> RLSState:
    """The final posterior only, from one weighted reduction over the stream
    (no trajectory): the combine of all T leaves is
    ``(sum_t W_t Lam_t, sum_t W_t b_t, prod_t lam_t)`` with ``W_t`` the product
    of the weights after step t."""
    Lam, b, w = rls_leaf_elements(params, regressors, measurements)
    after = torch.cat([torch.flip(torch.cumprod(torch.flip(w[1:], (0,)), 0), (0,)),
                       torch.ones_like(w[:1])])                          # W_t, (T, ...)
    Lam_T = (after[..., None, None] * Lam).sum(0)
    b_T = (after[..., None] * b).sum(0)
    return _states_from_aggregates(state0, Lam_T, b_T, torch.prod(w, 0))


def rls_parallel_sharded(params: RLSParams, state0: RLSState, regressors: torch.Tensor,
                         measurements: torch.Tensor, mesh, axis_name: str
                         ) -> Tuple[RLSState, torch.Tensor]:
    """The stream sharded over the ranks of ``mesh``'s axis ``axis_name``.

    Called by every rank of the axis with the whole stream (``T``, divisible
    by the axis size, leading): each rank scans its own contiguous block,
    one all-gather hands every rank each block's aggregate (p^2 + p + 1
    numbers a lane), and each rank folds the blocks before its own into its
    local results (an exclusive prefix over the blocks). Each rank turns its
    block into states; one more all-gather returns the whole trajectory, so
    every rank returns ``(final_state, thetas)`` as :func:`rls_parallel`
    does. The traffic does not grow with the block's length.
    """
    T = regressors.shape[0]
    n_shards = axis_size(mesh, axis_name)
    if T % n_shards:
        raise ValueError(f"stream length {T} not divisible by {n_shards}")
    idx, block = axis_index(mesh, axis_name), T // n_shards
    group = mesh.get_group(axis_name)
    own = slice(idx * block, (idx + 1) * block)
    Lam, b, w = associative_scan(
        rls_combine, rls_leaf_elements(params, regressors[own], measurements[own]))
    # every rank sees every block's aggregate and folds in those before its own
    gathered = all_gather_tree((Lam[-1], b[-1], w[-1]), group)   # (n_shards, ...) each
    prefix = tuple(torch.zeros_like(g[0]) for g in gathered[:2]) + (torch.ones_like(w[-1]),)
    for j in range(idx):
        prefix = rls_combine(prefix, tuple(g[j] for g in gathered))
    states = _states_from_aggregates(state0, *rls_combine(prefix, (Lam, b, w)))
    theta, cov = gather_batch((states.theta, states.covariance), mesh, axis_name)
    return RLSState(theta[-1], cov[-1]), theta
