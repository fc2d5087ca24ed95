"""Frozen yardsticks: the H100 SXM's published peaks and K1's useful work.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
the full 700 W power limit; a run reports the card's own limit beside them.
K1's count is the stage's useful work whatever implements it: two products
``w G2`` and ``tau G2^T`` of ``2 m n B`` FLOPs an iteration, and every input
and output read or written once. Neither reads anything from the program.
"""

from __future__ import annotations

#: dense bf16 tensor-core peak, FLOP/s
BF16_FLOPS = 989e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
SPEC = "NVIDIA H100 SXM data sheet, dense, at 700 W"


def k1_flops(B: int, m: int, n: int, iters: int) -> float:
    """Useful FLOPs of one ADMM stage of ``iters`` iterations over ``B`` lanes."""
    return 2.0 * 2.0 * m * n * B * iters


def k1_bytes(B: int, m: int, n: int, dtype_bytes: int = 4) -> float:
    """Bytes of one stage: v, l, u, tau, gq, s read; v and tau written; G2,
    d and rho read once."""
    return float(dtype_bytes * (B * ((3 * m + 2 * n + 1) + (m + n)) + m * n + m + n))


def k1_bound_s(B: int, m: int, n: int, iters: int) -> float:
    """The least time one stage can take on the card: the larger of its
    useful FLOPs at the bf16 peak and its bytes at the HBM bandwidth."""
    return max(k1_flops(B, m, n, iters) / BF16_FLOPS, k1_bytes(B, m, n) / HBM_BYTES_PER_S)
