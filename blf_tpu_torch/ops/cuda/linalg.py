"""Batched inverse and solve of small SPD matrices: CUDA kernel wrappers and
plain versions.

Counterpart of ``blf_tpu/ops/pallas/linalg.py``; everything of it is ported.
Both kernels run the reference's left-looking Cholesky factorization
(``_chol_into``):

- K3, ``cholesky_inverse_lane`` (``_inverse_kernel``): ``K`` (B, n, n) ->
  ``K^-1`` (B, n, n) by the factor, ``L^-1`` by forward substitution, then
  ``K^-1 = L^-T L^-1`` (``csrc/chol_lane.cu``: one warp a matrix);
- K4, ``cholesky_solve_lane`` (``_solve_kernel``): ``K`` (B, n, n), ``b``
  (B, n) -> ``K^-1 b`` (B, n) by the factor and a forward and a backward
  substitution (``csrc/chol_solve.cu``: one thread a matrix up to
  :data:`SOLVE_N_REG`, one warp a matrix past it; :func:`solve_plan`);
  ``spd_solve_lane`` dispatches to it.

A matrix that is not positive definite, or holds a NaN, yields NaN in its own
output only (no exception on the device; the callers' per-lane status absorbs
it).

Layout is lane-major ``(B, n, n)`` at the boundary and in device memory, one
contiguous block a matrix; the reference's batch-minor transpose, its padding
of the batch with identities, ``block_lanes`` and ``interpret`` are TPU
matters and have no counterpart here.

- :func:`cholesky_inverse_lane_reference` and
  :func:`cholesky_solve_lane_reference` are the plain PyTorch versions: the
  kernels' arithmetic column by column on batched tensors (they call nothing
  of ``torch.linalg``), any float dtype.
- :func:`cholesky_inverse_lane` and :func:`cholesky_solve_lane` run the plain
  version for tensors that lie on the CPU and launch the hand-written kernel
  for CUDA tensors. There they launch or raise: nothing falls back. Each
  kernel has its own counts (:func:`launch_count` / :func:`reference_count`
  for K3, :func:`solve_launch_count` / :func:`solve_reference_count` for K4).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from blf_tpu_torch.ops.cuda import _build
from blf_tpu_torch.ops.linalg import cholesky_nan

__all__ = ["cholesky_inverse_lane", "cholesky_inverse_lane_reference",
           "cholesky_solve_lane", "cholesky_solve_lane_reference", "spd_solve_lane",
           "launch_count", "reference_count", "solve_launch_count",
           "solve_reference_count", "reset_counts", "inverse_stride",
           "inverse_shared_bytes", "inverse_kernel_attributes", "solve_shared_bytes",
           "solve_plan", "SolvePlan", "solve_kernel_attributes", "build_chol_lane",
           "build_chol_solve", "SOLVE_MAX_N", "SOLVE_N_REG", "SOLVE_THREADS",
           "SOURCE", "REPLACES", "SOLVE_SOURCE", "SOLVE_REPLACES"]

SOURCE = "chol_lane.cu"
#: the TPU kernel K3 replaces (file:line of ``_inverse_kernel``)
REPLACES = "blf_tpu/ops/pallas/linalg.py:61"
SOLVE_SOURCE = "chol_solve.cu"
#: the TPU kernel K4 replaces (file:line of ``_solve_kernel``)
SOLVE_REPLACES = "blf_tpu/ops/pallas/linalg.py:81"

_MAX_SHARED = 232448        # bytes of shared memory a block may use on sm_90

# Plain integers, per kernel: how often it was launched, and how often its
# plain version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0, "solve_launch": 0, "solve_reference": 0}
_launches_by_n: Dict[int, int] = {}       # K3 launches by matrix size
_libs: Dict[int, ctypes.CDLL] = {}
_solve_libs: Dict[int, ctypes.CDLL] = {}
_solve_fns: Dict[int, object] = {}         # K4's launch function by n


def launch_count(n: Optional[int] = None) -> int:
    """K3 launches since the last :func:`reset_counts`; with ``n``, those at
    matrix size ``n`` only."""
    return _counts["launch"] if n is None else _launches_by_n.get(n, 0)


def reference_count() -> int:
    """Plain-version runs made by :func:`cholesky_inverse_lane` for CPU tensors."""
    return _counts["reference"]


def solve_launch_count() -> int:
    """K4 launches since the last :func:`reset_counts`."""
    return _counts["solve_launch"]


def solve_reference_count() -> int:
    """Plain-version runs made by :func:`cholesky_solve_lane` for CPU tensors."""
    return _counts["solve_reference"]


def reset_counts() -> None:
    """Set the counts of both kernels to 0."""
    for key in _counts:
        _counts[key] = 0
    _launches_by_n.clear()


def _cholesky_columns(K: torch.Tensor):
    """The kernels' factorization (``chol_lane.cu``, ``chol_solve.cu``),
    column by column: the lower factor ``L`` (B, n, n) with ``L[j, j] = s d``."""
    n = K.shape[-1]
    L = torch.zeros_like(K)
    for j in range(n):
        lj = L[:, j, :j]                                          # (B, j)
        s = K[:, j, j] - (lj * lj).sum(dim=-1)
        d = 1.0 / torch.sqrt(s)
        L[:, j, j] = s * d
        if j + 1 < n:
            rows = K[:, j + 1:, j] - (L[:, j + 1:, :j] * lj[:, None, :]).sum(dim=-1)
            L[:, j + 1:, j] = rows * d[:, None]
    return L


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
    n = K.shape[-1]
    L = _cholesky_columns(K)
    Linv = torch.zeros_like(K)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    for i in range(n):
        acc = (L[:, i, :i, None] * Linv[:, :i, :]).sum(dim=1)     # (B, n)
        Linv[:, i, :] = (eye[i] - acc) * (1.0 / L[:, i, i])[:, None]
    return torch.einsum("bki,bkj->bij", Linv, Linv)


def inverse_stride(n: int) -> int:
    """Row stride of the K3 kernel's matrix in shared memory: the least
    ``s >= n`` with ``s = 4 (mod 8)``, so that the eight rows one 16-byte load
    phase reads lie on distinct banks."""
    return n + (12 - n % 8) % 8


def inverse_shared_bytes(n: int) -> int:
    """Shared memory one block (one warp, one matrix) of the K3 kernel needs
    at size ``n``: the matrix, once."""
    return 4 * n * inverse_stride(n)


def build_chol_lane(n: int) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library for size ``n``."""
    lib = _libs.get(n)
    if lib is not None:
        return lib
    if n < 1 or inverse_shared_bytes(n) > _MAX_SHARED:
        raise ValueError(
            f"cholesky_inverse_lane kernel keeps the matrix (then its factor and"
            f" the factor's inverse) in shared memory: n = {n} needs"
            f" {inverse_shared_bytes(n)} bytes, the card offers {_MAX_SHARED}")
    lib = _build.load_library(SOURCE, {"CHOL_N": n})
    P = ctypes.c_void_p
    lib.blf_chol_inverse_f32.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, P]
    lib.blf_chol_inverse_f32.restype = ctypes.c_int
    lib.blf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_chol_lane_n.argtypes = []
    lib.blf_chol_lane_n.restype = ctypes.c_int
    lib.blf_chol_lane_smem_bytes.argtypes = []
    lib.blf_chol_lane_smem_bytes.restype = ctypes.c_int
    lib.blf_chol_lane_attributes.argtypes = [P]
    lib.blf_chol_lane_attributes.restype = ctypes.c_int
    if lib.blf_chol_lane_n() != n:
        raise RuntimeError("chol_lane library was compiled for another size")
    if lib.blf_chol_lane_smem_bytes() != inverse_shared_bytes(n):
        raise RuntimeError("chol_lane library disagrees with its wrapper on the"
                           " shared-memory layout")
    _libs[n] = lib
    return lib


def inverse_kernel_attributes(n: int) -> Dict[str, int]:
    """Registers a thread, local (spill) bytes a thread and matrices an SM of
    the K3 kernel built for size ``n``, as the CUDA runtime reports them."""
    lib = build_chol_lane(n)
    out = (ctypes.c_int * 3)()
    code = lib.blf_chol_lane_attributes(ctypes.addressof(out))
    if code != 0:
        raise RuntimeError(f"chol_lane attributes: {lib.blf_cuda_error_string(code).decode()}")
    return {"registers": out[0], "local_bytes": out[1], "matrices_per_sm": out[2]}


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
    _launches_by_n[n] = _launches_by_n.get(n, 0) + 1
    return out


# ---------------------------------------------------------------------------
# K4: the batched SPD solve, one right-hand side
# ---------------------------------------------------------------------------

def cholesky_solve_lane_reference(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any float dtype, any device): ``K`` (B, n, n),
    ``b`` (B, n) -> ``K^-1 b`` (B, n), by the kernel's own steps.

    The factor as in :func:`cholesky_inverse_lane_reference`, then
    ``y[i] = (b[i] - sum_k<i L[i, k] y[k]) / L[i, i]`` and
    ``x[i] = (y[i] - sum_k>i L[k, i] x[k]) / L[i, i]``. A lane whose pivot
    has ``!(s > 0)`` or ``s = inf`` gets NaN in its whole ``x``, as the
    kernel writes it; other lanes never mix in.
    """
    if K.dim() != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"K must be (B, n, n), got {tuple(K.shape)}")
    if tuple(b.shape) != tuple(K.shape[:2]):
        raise ValueError(f"b must be (B, n) = {tuple(K.shape[:2])}, got {tuple(b.shape)}")
    n = K.shape[-1]
    L = _cholesky_columns(K)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)                    # L[j, j] = s d
    # s d is NaN exactly where the kernel flags the pivot: s <= 0, NaN or inf
    bad = ~(diag > 0).all(dim=-1)
    y = torch.zeros_like(b)
    for i in range(n):
        acc = (L[:, i, :i] * y[:, :i]).sum(dim=-1)
        y[:, i] = (b[:, i] - acc) / diag[:, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        acc = (L[:, i + 1:, i] * x[:, i + 1:]).sum(dim=-1)
        x[:, i] = (y[:, i] - acc) / diag[:, i]
    return torch.where(bad[:, None], torch.full_like(x, float("nan")), x)


#: the largest n the solve kernel takes: its first design's bound (the factor,
#: rows padded to n + 1, and three vectors in 227 KB of shared memory), kept
SOLVE_MAX_N = 239
#: the largest n solved one thread a matrix (``N_REG`` in the source)
SOLVE_N_REG = 20
#: threads (matrices) a block on that path (``THREADS_T``)
SOLVE_THREADS = 32
_SMEM_DEFAULT = 48 * 1024   # dynamic shared memory a block gets without opting in


class SolvePlan(NamedTuple):
    """How ``csrc/chol_solve.cu`` lays out size ``n``: ``path`` "thread" (one
    thread a matrix, n <= :data:`SOLVE_N_REG`) or "warp" (one warp a matrix);
    ``stride`` the floats of a thread's slot (K then b) or of a matrix row in
    shared memory, odd on both paths."""
    path: str
    threads: int
    matrices_per_block: int
    stride: int
    shared_bytes: int


def solve_plan(n: int) -> SolvePlan:
    """The solve kernel's compile-time plan at size ``n``, as the library
    reports it (checked when it is loaded)."""
    if n <= SOLVE_N_REG:
        slot = n * n + n + 1
        return SolvePlan("thread", SOLVE_THREADS, SOLVE_THREADS, slot, 4 * SOLVE_THREADS * slot)
    stride = n | 1
    per = 4 * n * stride
    w = max(1, min(4, _SMEM_DEFAULT // per))
    return SolvePlan("warp", 32 * w, w, stride, w * per)


def solve_shared_bytes(n: int) -> int:
    """Shared memory one block of the solve kernel needs at size ``n``."""
    return solve_plan(n).shared_bytes


def build_chol_solve(n: int) -> ctypes.CDLL:
    """Build (at first use) and load the solve kernel's library for size ``n``."""
    lib = _solve_libs.get(n)
    if lib is not None:
        return lib
    if n < 1 or n > SOLVE_MAX_N:
        raise ValueError(
            f"cholesky_solve_lane kernel keeps the matrix in shared memory: it takes"
            f" n from 1 to {SOLVE_MAX_N}, not {n}")
    lib = _build.load_library(SOLVE_SOURCE, {"CHOL_N": n})
    P = ctypes.c_void_p
    lib.blf_chol_solve_f32.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_int, P]
    lib.blf_chol_solve_f32.restype = ctypes.c_int
    lib.blf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_chol_solve_n.argtypes = []
    lib.blf_chol_solve_n.restype = ctypes.c_int
    lib.blf_chol_solve_plan.argtypes = [P]
    lib.blf_chol_solve_plan.restype = None
    lib.blf_chol_solve_empty.argtypes = [ctypes.c_longlong, P]
    lib.blf_chol_solve_empty.restype = ctypes.c_int
    lib.blf_chol_solve_attributes.argtypes = [P]
    lib.blf_chol_solve_attributes.restype = ctypes.c_int
    if lib.blf_chol_solve_n() != n:
        raise RuntimeError("chol_solve library was compiled for another size")
    out = (ctypes.c_int * 5)()
    lib.blf_chol_solve_plan(ctypes.addressof(out))
    plan = solve_plan(n)
    if (("thread", "warp")[out[0]],) + tuple(out[1:]) != tuple(plan):
        raise RuntimeError(f"chol_solve library's plan {list(out)} disagrees with its"
                           f" wrapper's {plan}")
    _solve_libs[n] = lib
    _solve_fns[n] = lib.blf_chol_solve_f32
    return lib


def solve_kernel_attributes(n: int) -> Dict[str, int]:
    """Registers a thread, local (spill) bytes a thread and matrices an SM of
    the solve kernel built for size ``n``, as the CUDA runtime reports them."""
    lib = build_chol_solve(n)
    out = (ctypes.c_int * 3)()
    code = lib.blf_chol_solve_attributes(ctypes.addressof(out))
    if code != 0:
        raise RuntimeError(f"chol_solve attributes: {_solve_error(lib, code)}")
    return {"registers": out[0], "local_bytes": out[1],
            "matrices_per_sm": out[2] * solve_plan(n).matrices_per_block}


def _solve_error(lib, code: int) -> str:
    if code > 0:
        return lib.blf_cuda_error_string(code).decode()
    return {-1: "library compiled for another size", -2: "bad batch",
            -3: "device ordinal past 63"}.get(code, "?")


def cholesky_solve_lane(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve: ``K`` (B, n, n), ``b`` (B, n) -> ``K^-1 b`` (B, n).

    CPU tensors go through :func:`cholesky_solve_lane_reference`. CUDA
    tensors must be contiguous float32 on one device; the kernel is launched
    on that device's current stream, its launch error is checked, and the
    call does not synchronise. The launch path is light: the library's
    function is cached by n, and no device context is entered when the
    tensors lie on the current device.
    """
    if K.device.type == "cpu" and b.device.type == "cpu":
        _counts["solve_reference"] += 1
        return cholesky_solve_lane_reference(K, b)
    device = K.device
    if device.type != "cuda" or b.device != device:
        raise ValueError(
            f"cholesky_solve_lane runs on cpu or cuda tensors of one device, not"
            f" {device} and {b.device}")
    if K.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(
            f"cholesky_solve_lane kernel is float32 only; K is {K.dtype}, b is {b.dtype}")
    shape = K.shape
    if (len(shape) != 3 or shape[2] != shape[1] or shape[0] < 1
            or b.shape != shape[:2]):
        raise ValueError(f"K must be (B, n, n) with B >= 1 and b (B, n), got"
                         f" {tuple(shape)} and {tuple(b.shape)}")
    if not (K.is_contiguous() and b.is_contiguous()):
        raise ValueError("K and b must be contiguous")
    B, n = shape[0], shape[1]
    fn = _solve_fns.get(n)
    if fn is None:
        build_chol_solve(n)
        fn = _solve_fns[n]
    out = torch.empty_like(b)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        code = fn(K.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, stream)
    else:
        with torch.cuda.device(device):
            code = fn(K.data_ptr(), b.data_ptr(), out.data_ptr(), B, n, stream)
    if code != 0:
        raise RuntimeError(f"cholesky_solve_lane launch failed ({code}):"
                           f" {_solve_error(_solve_libs[n], code)}")
    _counts["solve_launch"] += 1
    return out


def spd_solve_lane(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dispatch: ``K`` (..., n, n), ``b`` (..., n) -> ``K^-1 b``.

    Exactly one leading batch axis (a fleet) goes to :func:`cholesky_solve_lane`,
    the kernel on CUDA tensors; anything else (an unbatched call, nested batch
    axes) goes to a dense Cholesky solve by the library, as the reference's
    ``cho_solve`` does, with a matrix that is not positive definite giving
    NaN in its own solution.
    """
    if K.dim() == 3 and b.dim() == 2 and K.shape[0] == b.shape[0]:
        return cholesky_solve_lane(K, b)
    L = cholesky_nan(K)
    return torch.cholesky_solve(b[..., None], L)[..., 0]
