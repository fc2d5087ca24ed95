"""Fused per-lane ADMM stage: CUDA kernel wrapper and plain version.

Counterpart of ``blf_tpu/ops/pallas/admm_lane.py`` (``admm_lane_stage`` over
``_lane_kernel``). One call runs ``iters`` iterations of the v-space ADMM
recursion for a fleet in which every lane has its own operators, as the
whole-body QP has (each lane's own mass matrix and contact Jacobians)::

    z  = clip(v, l, u)
    w  = rho * (2 z - v)            ( = rho z - y )
    x  = Kinv (A' w - q)            (K = P + sigma I + A' rho A, prefactored)
    v += alpha (A x - z)

and returns ``(v, x)``: the iterate and the last iteration's primal in the
scaled frame (``z = clip(v, l, u)`` and ``y = rho (v - z)`` are recovered
views). Pure float32 arithmetic on the card.

Layout is lane-major: ``v, rho, l, u`` (B, m); ``q`` (B, n); ``A`` (B, m, n);
``Kinv`` (B, n, n), each lane's operators one contiguous block. The
reference's batch-minor ``(m, n, B)`` layout, its padding of the batch with
identity lanes, ``block_lanes`` and ``interpret`` are TPU matters and have no
counterpart here: the kernel runs one block a lane, so any ``B >= 1`` is
taken. Each thread keeps a tile of its lane's A and Kinv in registers for
the whole stage; :func:`lane_plan` says how the kernel compiled for a shape
lays them out (it mirrors the kernel's compile-time plan).

- :func:`admm_lane_stage_reference` is the plain PyTorch loop, any float dtype.
- :func:`admm_lane_stage` runs the plain loop for tensors that lie on the CPU
  and launches the hand-written kernel ``csrc/admm_lane.cu`` for CUDA tensors.
  There it launches or raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from blf_tpu_torch.ops.cuda import _build

__all__ = ["admm_lane_stage", "admm_lane_stage_reference", "launch_count",
           "reference_count", "reset_counts", "LanePlan", "lane_plan",
           "lane_shared_bytes", "build_admm_lane", "kernel_attributes", "SOURCE",
           "REPLACES"]

SOURCE = "admm_lane.cu"
#: the TPU kernel this one replaces (file:line of ``_lane_kernel``)
REPLACES = "blf_tpu/ops/pallas/admm_lane.py:56"

_MAX_SHARED = 232448        # bytes of shared memory a block may use on sm_90
_REGISTER_FLOATS = 96       # operator floats a thread keeps in registers
_MAX_COLUMNS = 32           # columns a warp may own: n <= 256

# Plain integers: how often the kernel was launched, and how often the plain
# version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0}
_libs: Dict[Tuple[int, int], ctypes.CDLL] = {}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_counts`."""
    return _counts["launch"]


def reference_count() -> int:
    """Plain-version runs made by :func:`admm_lane_stage` for CPU tensors."""
    return _counts["reference"]


def reset_counts() -> None:
    _counts["launch"] = 0
    _counts["reference"] = 0


def _clip(v, l, u):
    # min(max(v, l), u): passes a NaN of v, l or u on, as jnp.clip does
    return torch.minimum(torch.maximum(v, l), u)


def admm_lane_stage_reference(v, rho, A, Kinv, q, l, u, *, iters: int,
                              alpha: float = 1.6):
    """Plain PyTorch version of the stage (any float dtype, any device).

    Shapes: ``v, rho, l, u`` (B, m); ``q`` (B, n); ``A`` (B, m, n); ``Kinv``
    (B, n, n). Returns ``(v, x)``.
    """
    if iters < 1:
        raise ValueError("iters must be >= 1")
    x = None
    for _ in range(iters):
        z = _clip(v, l, u)
        w = rho * (2.0 * z - v)
        rhs = torch.einsum("bmn,bm->bn", A, w) - q
        x = torch.einsum("bij,bj->bi", Kinv, rhs)
        v = v + alpha * (torch.einsum("bmn,bn->bm", A, x) - z)
    return v, x


class LanePlan(NamedTuple):
    """How the kernel compiled for ``(m, n)`` lays out one lane (one block).

    Warp ``w`` of ``warps`` owns the columns ``[w cols, (w + 1) cols)`` of A
    and Kinv; lane ``l`` of every warp owns the rows ``l, l + 32, ...`` of A
    (``rows`` of them) and the outputs ``l, l + 32, ...`` of x (``outs``).
    The first ``rows_in_registers`` rows and ``outs_in_registers`` outputs of
    a thread's tile are registers, the rest shared memory; operators are
    staged from device memory ``staged_rows`` rows at a time."""
    warps: int
    cols: int
    rows: int
    rows_in_registers: int
    outs: int
    outs_in_registers: int
    staged_rows: int
    shared_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def lane_plan(m: int, n: int) -> LanePlan:
    """The kernel's compile-time plan for shape ``(m, n)`` (``csrc/admm_lane.cu``).

    ``clamp(ceil(n / 8), 1, 8)`` warps a lane. Raises ValueError for
    a shape the kernel does not take: an empty one, one whose warp would own
    more than 32 columns (n > 256), or one whose exchange buffers and
    operator tails exceed the card's shared memory.
    """
    if m < 1 or n < 1:
        raise ValueError(f"admm_lane_stage needs m, n >= 1, got ({m}, {n})")
    w = min(8, max(1, _cdiv(n, 8)))
    cols = _cdiv(n, w)
    if cols > _MAX_COLUMNS:
        raise ValueError(
            f"admm_lane_stage kernel: (m, n) = ({m}, {n}) puts {cols} columns on a"
            f" warp, at most {_MAX_COLUMNS} are taken (n <= 256)")
    cols_pow2 = 1 << (cols - 1).bit_length()
    rows, outs = _cdiv(m, 32), _cdiv(n, 32)
    rows_reg = min(rows, _REGISTER_FLOATS // cols)
    outs_reg = min(outs, (_REGISTER_FLOATS - rows_reg * cols) // cols)
    x_words = max(32 * outs, w * cols)
    stride = n | 1
    floats = (2 * w * cols_pow2 + w * x_words + w * 32 * rows
              + w * (rows - rows_reg) * cols * 32 + w * (outs - outs_reg) * cols * 32)
    # the staging buffer of the prologue, then w
    staged = 32 if floats + max(32 * stride, 32 * rows) <= _MAX_SHARED // 4 else 8
    need = 4 * (floats + max(staged * stride, 32 * rows))
    if need > _MAX_SHARED:
        raise ValueError(
            f"admm_lane_stage kernel: (m, n) = ({m}, {n}) needs {need} bytes of"
            f" shared memory for its exchange buffers and the operator rows that"
            f" do not fit in registers, the card offers {_MAX_SHARED}")
    return LanePlan(w, cols, rows, rows_reg, outs, outs_reg, staged, need)


def lane_shared_bytes(m: int, n: int) -> int:
    """Shared memory one block of the kernel needs at shape ``(m, n)``."""
    return lane_plan(m, n).shared_bytes


def build_admm_lane(m: int, n: int) -> ctypes.CDLL:
    """Build (at first use) and load the kernel library for shape ``(m, n)``."""
    lib = _libs.get((m, n))
    if lib is not None:
        return lib
    plan = lane_plan(m, n)
    lib = _build.load_library(SOURCE, {"ADMM_M": m, "ADMM_N": n})
    P = ctypes.c_void_p
    lib.blf_admm_lane_stage_f32.argtypes = [P] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, P]
    lib.blf_admm_lane_stage_f32.restype = ctypes.c_int
    lib.blf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_admm_lane_plan.argtypes = [P]
    lib.blf_admm_lane_plan.restype = None
    lib.blf_admm_lane_attributes.argtypes = [P]
    lib.blf_admm_lane_attributes.restype = ctypes.c_int
    got = (ctypes.c_int * 8)()
    lib.blf_admm_lane_plan(ctypes.addressof(got))
    if tuple(got) != tuple(plan):
        raise RuntimeError(f"admm_lane library disagrees with its wrapper on the"
                           f" layout: {tuple(got)} against {plan}")
    _libs[(m, n)] = lib
    return lib


def kernel_attributes(m: int, n: int) -> Dict[str, int]:
    """Registers a thread, local (spill) bytes a thread and lanes an SM of the
    kernel built for ``(m, n)``, as the CUDA runtime reports them."""
    lib = build_admm_lane(m, n)
    out = (ctypes.c_int * 3)()
    code = lib.blf_admm_lane_attributes(ctypes.addressof(out))
    if code != 0:
        raise RuntimeError(f"admm_lane attributes: {lib.blf_cuda_error_string(code).decode()}")
    return {"registers": out[0], "local_bytes": out[1], "lanes_per_sm": out[2]}


def _require(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"admm_lane_stage kernel is float32 only; {name} is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def admm_lane_stage(v, rho, A, Kinv, q, l, u, *, iters: int, alpha: float = 1.6):
    """Run ``iters`` fused per-lane ADMM iterations; returns new ``(v, x)``.

    CPU tensors go through :func:`admm_lane_stage_reference`. CUDA tensors
    must be contiguous float32 of the documented shapes; the kernel is
    launched on the current stream, its launch error is checked, and the call
    does not synchronise. ``+-inf`` bounds are fine.
    """
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if v.device.type == "cpu":
        _counts["reference"] += 1
        return admm_lane_stage_reference(v, rho, A, Kinv, q, l, u,
                                         iters=iters, alpha=alpha)
    if v.device.type != "cuda":
        raise ValueError(f"admm_lane_stage runs on cpu or cuda tensors, not {v.device}")
    if v.dim() != 2 or A.dim() != 3:
        raise ValueError("v must be (B, m) and A (B, m, n)")
    B, m = v.shape
    n = A.shape[2]
    if B < 1:
        raise ValueError("admm_lane_stage needs at least one lane")
    dev = v.device
    _require(v, "v", (B, m), dev)
    _require(rho, "rho", (B, m), dev)
    _require(A, "A", (B, m, n), dev)
    _require(Kinv, "Kinv", (B, n, n), dev)
    _require(q, "q", (B, n), dev)
    _require(l, "l", (B, m), dev)
    _require(u, "u", (B, m), dev)
    lib = build_admm_lane(m, n)
    v_out = torch.empty_like(v)
    x_out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.blf_admm_lane_stage_f32(
            v.data_ptr(), rho.data_ptr(), A.data_ptr(), Kinv.data_ptr(),
            q.data_ptr(), l.data_ptr(), u.data_ptr(), v_out.data_ptr(),
            x_out.data_ptr(), B, m, n, int(iters), float(alpha), stream)
    if code != 0:
        what = (lib.blf_cuda_error_string(code).decode() if code > 0
                else {-1: "library compiled for another shape",
                      -2: "bad batch or iteration count"}.get(code, "?"))
        raise RuntimeError(f"admm_lane_stage launch failed ({code}): {what}")
    _counts["launch"] += 1
    return v_out, x_out
