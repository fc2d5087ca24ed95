"""Batched small-matrix linear algebra as plain elementwise tensor ops.

Counterpart of ``blf_tpu/ops/linalg.py``; everything of it is ported. The
Cholesky factorization and the two triangular solves are unrolled over the
*static* small dimension ``m`` (the innovation/measurement dimension, 2-8 in
every use of the framework) and vectorized over arbitrary leading batch
axes: a fleet of 2x2 systems becomes a handful of elementwise kernels, with
no call into a batched LAPACK routine and no host synchronisation.
"""

from __future__ import annotations

import torch

__all__ = ["cholesky_small", "solve_psd_small", "solve_psd", "cholesky_nan",
           "MAX_UNROLLED"]

# Above this size the O(m^3) unrolled op count stops paying for itself.
MAX_UNROLLED = 8


def _chol_entries(S, eps: float):
    """Unrolled lower-Cholesky entries of PSD ``S`` (..., m, m) as a list of
    lists of (...,) tensors; ``eps`` floors the pivot before the sqrt."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    return L


def cholesky_small(S: torch.Tensor, *, eps: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of a batch of small PSD matrices, unrolled.

    ``S``: (..., m, m) with static ``m`` <= ~8. Matches
    ``torch.linalg.cholesky`` up to the ``eps`` pivot floor.
    """
    m = S.shape[-1]
    L = _chol_entries(S, eps)
    zero = torch.zeros_like(S[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(m)], dim=-1)
            for i in range(m)]
    return torch.stack(rows, dim=-2)


def solve_psd_small(S: torch.Tensor, B: torch.Tensor, *,
                    eps: float = 0.0) -> torch.Tensor:
    """``S^-1 B`` for batched small PSD ``S`` via unrolled Cholesky.

    ``S``: (..., m, m) with static small ``m``; ``B``: (..., m, k) or (..., m).
    """
    m = S.shape[-1]
    vec = B.dim() == S.dim() - 1
    if vec:
        B = B[..., None]
    L = _chol_entries(S, eps)
    # forward substitution L y = B
    y = []
    for i in range(m):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[i][k][..., None] * y[k]
        y.append(acc / L[i][i][..., None])
    # back substitution L^T x = y
    x = [None] * m
    for i in reversed(range(m)):
        acc = y[i]
        for k in range(i + 1, m):
            acc = acc - L[k][i][..., None] * x[k]
        x[i] = acc / L[i][i][..., None]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def solve_psd(S: torch.Tensor, B: torch.Tensor, *, eps: float = 0.0,
              max_unrolled: int = MAX_UNROLLED) -> torch.Tensor:
    """PSD solve that picks its path by static size: small ``m`` ->
    :func:`solve_psd_small`; larger ``m`` -> an LU solve. A singular matrix
    spoils its own lane and raises nothing (``torch.linalg.solve`` would raise
    for the whole batch; ``jnp.linalg.solve`` does not)."""
    if S.shape[-1] <= max_unrolled:
        return solve_psd_small(S, B, eps=eps)
    if B.dim() == S.dim() - 1:
        return torch.linalg.solve_ex(S, B[..., None])[0][..., 0]
    return torch.linalg.solve_ex(S, B)[0]


def cholesky_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n) by the library's batched routine;
    a matrix that is not positive definite, or holds a NaN, gives NaN for
    that matrix only.

    ``torch.linalg.cholesky`` raises for the whole batch where
    ``jnp.linalg.cholesky`` returns NaN per matrix. Here failure stays
    per-lane data, which :mod:`blf_tpu_torch.utils.status` then quarantines.
    """
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)
