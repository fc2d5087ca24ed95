"""Batched inverse of small SPD matrices: CUDA kernel wrapper and plain version.

Counterpart of ``blf_tpu/ops/pallas/linalg.py``, of which this slice ports
``cholesky_inverse_lane`` (``_inverse_kernel`` over ``_chol_into``): ``K``
(B, n, n) -> ``K^-1`` (B, n, n) by a left-looking Cholesky factorization,
``L^-1`` by forward substitution, then ``K^-1 = L^-T L^-1``. A matrix that is
not positive definite, or holds a NaN, yields NaN in its own output only (no
exception on the device; the callers' per-lane status absorbs it).

Layout is lane-major ``(B, n, n)`` at the boundary and in device memory, one
contiguous block a matrix; the reference's batch-minor transpose, its padding
of the batch with identities, ``block_lanes`` and ``interpret`` are TPU
matters and have no counterpart here.

- :func:`cholesky_inverse_lane_reference` is the plain PyTorch version: the
  kernel's arithmetic column by column on batched tensors (it calls nothing
  of ``torch.linalg``), any float dtype.
- :func:`cholesky_inverse_lane` runs the plain version for tensors that lie
  on the CPU and launches the hand-written kernel ``csrc/chol_lane.cu`` for
  CUDA tensors. There it launches or raises: nothing falls back.

Not yet ported: ``cholesky_solve_lane`` / ``spd_solve_lane`` (the
single-right-hand-side solve kernel; ROADMAP.md, slice 2b).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from blf_tpu_torch.ops.cuda import _build

__all__ = ["cholesky_inverse_lane", "cholesky_inverse_lane_reference",
           "launch_count", "reference_count", "reset_counts",
           "inverse_shared_bytes", "build_chol_lane", "SOURCE", "REPLACES"]

SOURCE = "chol_lane.cu"
#: the TPU kernel this one replaces (file:line of ``_inverse_kernel``)
REPLACES = "blf_tpu/ops/pallas/linalg.py:61"

_MAX_SHARED = 232448        # bytes of shared memory a block may use on sm_90

# Plain integers: how often the kernel was launched, and how often the plain
# version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0}
_libs: Dict[int, ctypes.CDLL] = {}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_counts`."""
    return _counts["launch"]


def reference_count() -> int:
    """Plain-version runs made by :func:`cholesky_inverse_lane` for CPU tensors."""
    return _counts["reference"]


def reset_counts() -> None:
    _counts["launch"] = 0
    _counts["reference"] = 0


def cholesky_inverse_lane_reference(K: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any float dtype, any device): ``K`` (B, n, n)
    -> ``K^-1``, by the kernel's own steps.

    Column j of the factor: ``s = K[j, j] - sum_k L[j, k]^2``,
    ``d = 1 / sqrt(s)``, ``L[j, j] = s d``, ``L[i, j] = (K[i, j] -
    sum_k L[i, k] L[j, k]) d``. Row i of the inverse factor:
    ``Linv[i] = (e_i - sum_k L[i, k] Linv[k]) / L[i, i]``. Then
    ``Linv^T Linv``. Where ``s <= 0`` or NaN, ``d`` is NaN or inf and every
    entry of that matrix's result becomes NaN; other matrices never mix in.
    """
    if K.dim() != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"K must be (B, n, n), got {tuple(K.shape)}")
    B, n, _ = K.shape
    L = torch.zeros_like(K)
    for j in range(n):
        lj = L[:, j, :j]                                          # (B, j)
        s = K[:, j, j] - (lj * lj).sum(dim=-1)
        d = 1.0 / torch.sqrt(s)
        L[:, j, j] = s * d
        if j + 1 < n:
            rows = K[:, j + 1:, j] - (L[:, j + 1:, :j] * lj[:, None, :]).sum(dim=-1)
            L[:, j + 1:, j] = rows * d[:, None]
    Linv = torch.zeros_like(K)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    for i in range(n):
        acc = (L[:, i, :i, None] * Linv[:, :i, :]).sum(dim=1)     # (B, n)
        Linv[:, i, :] = (eye[i] - acc) * (1.0 / L[:, i, i])[:, None]
    return torch.einsum("bki,bkj->bij", Linv, Linv)


def inverse_shared_bytes(n: int) -> int:
    """Shared memory one block of the kernel needs at size ``n``."""
    return 4 * (2 * n * (n + 1) + n)


def build_chol_lane(n: int) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library for size ``n``."""
    lib = _libs.get(n)
    if lib is not None:
        return lib
    if n < 1 or inverse_shared_bytes(n) > _MAX_SHARED:
        raise ValueError(
            f"cholesky_inverse_lane kernel keeps the factor and its inverse in"
            f" shared memory: n = {n} needs {inverse_shared_bytes(n)} bytes,"
            f" the card offers {_MAX_SHARED}")
    lib = _build.load_library(SOURCE, {"CHOL_N": n})
    P = ctypes.c_void_p
    lib.blf_chol_inverse_f32.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, P]
    lib.blf_chol_inverse_f32.restype = ctypes.c_int
    lib.blf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_chol_lane_n.argtypes = []
    lib.blf_chol_lane_n.restype = ctypes.c_int
    if lib.blf_chol_lane_n() != n:
        raise RuntimeError("chol_lane library was compiled for another size")
    _libs[n] = lib
    return lib


def cholesky_inverse_lane(K: torch.Tensor) -> torch.Tensor:
    """Batched SPD inverse: ``K`` (B, n, n) -> ``K^-1`` (B, n, n).

    CPU tensors go through :func:`cholesky_inverse_lane_reference`. CUDA
    tensors must be contiguous float32; the kernel is launched on the current
    stream, its launch error is checked, and the call does not synchronise.
    """
    if K.device.type == "cpu":
        _counts["reference"] += 1
        return cholesky_inverse_lane_reference(K)
    if K.device.type != "cuda":
        raise ValueError(
            f"cholesky_inverse_lane runs on cpu or cuda tensors, not {K.device}")
    if K.dtype != torch.float32:
        raise TypeError(f"cholesky_inverse_lane kernel is float32 only; K is {K.dtype}")
    if K.dim() != 3 or K.shape[-1] != K.shape[-2] or K.shape[0] < 1:
        raise ValueError(f"K must be (B, n, n) with B >= 1, got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError("K must be contiguous")
    B, n, _ = K.shape
    lib = build_chol_lane(n)
    out = torch.empty_like(K)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.blf_chol_inverse_f32(K.data_ptr(), out.data_ptr(), B, n, stream)
    if code != 0:
        what = (lib.blf_cuda_error_string(code).decode() if code > 0
                else {-1: "library compiled for another size",
                      -2: "bad batch"}.get(code, "?"))
        raise RuntimeError(f"cholesky_inverse_lane launch failed ({code}): {what}")
    _counts["launch"] += 1
    return out
