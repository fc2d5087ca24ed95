"""Matmul-precision discipline of the port.

Counterpart of ``blf_tpu/ops/precision.py`` (``f32_matmuls``). There the
decorator forces full-f32 passes on a bf16 matrix unit; here the hazard is
TF32: with ``torch.backends.cuda.matmul.allow_tf32`` on, a float32 product on
the GPU keeps about three decimal digits, which shifts ADMM fixed points by
more than the convergence tolerance. Solver entry points are wrapped in
:func:`f32_matmuls`, which turns TF32 off for the call, asserts that it is
off, and restores the caller's setting afterwards. The CUDA kernels do exact
f32 FMA arithmetic and are built without ``-use_fast_math``.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["f32_matmuls"]


def f32_matmuls(fn):
    """Run ``fn`` with TF32 matrix products disabled."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        matmul = torch.backends.cuda.matmul
        before = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            if matmul.allow_tf32:
                raise RuntimeError("TF32 matmuls could not be disabled")
            return fn(*args, **kwargs)
        finally:
            matmul.allow_tf32 = before

    return wrapped
