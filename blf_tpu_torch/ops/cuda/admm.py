"""Fused shared-operator ADMM stage: CUDA kernel wrappers and plain versions.

Counterpart of ``blf_tpu/ops/pallas/admm.py`` (``admm_stage`` /
``admm_stage_t`` over ``_stage_kernel_t``) in its three matmul modes. One call
runs ``iters`` iterations, at a fixed per-lane penalty multiplier ``s``, of the
v-space recursion of :func:`blf_tpu_torch.mpc.qp.solve_qp_factored`::

    z   = clip(v, l, u)
    w   = rho * (2 z - v)
    tau = (w @ G2 - gq / s) * s / (1 + s d)
    v  += alpha (tau @ G2.T - z)

``matmul`` takes the reference's names:

- ``"f32"`` (the port's default): exact float32 products, the kernel
  ``csrc/admm_stage.cu`` (FMA units; why not the tensor cores: see its
  source).
- ``"split"``: every product a 3-pass sum of bf16 hi/lo products,
  ``A_hi b_hi + A_hi b_lo + A_lo b_hi`` (``admm.py:93-135``, ``:234-255``).
- ``"delta"``: 3-pass products in iteration 1, then 2-pass products of the
  bf16-rounded increments added into float32 carries (``admm.py:197-233``).
  ``"split"`` and ``"delta"`` run on the kernel ``csrc/admm_stage_tc.cu``
  (Hopper's tensor cores, ``wgmma``), float32 only. rho is folded into the
  first operator before its split, ``(rho . G2)^T``, as the reference does.

Layout is lane-major, ``(B, .)``, at the public boundary and inside the
kernels' device-memory traffic; the batch-minor transpose, the 128-lane
padding, ``block_lanes``/``chunks``/``unroll``/``interpret`` and the VMEM
guard of the reference are TPU matters and have no counterpart here.

- :func:`admm_stage_reference` is the plain PyTorch loop (``"f32"`` any float
  dtype; ``"split"``/``"delta"`` with the bf16 casts in torch and each pass a
  float32 product of bf16-valued tensors, TF32 off, summed in the reference's
  order).
- :func:`admm_stage` runs the plain loop for tensors that lie on the CPU and
  launches the mode's hand-written kernel for CUDA tensors. There it launches
  or raises: nothing falls back.
- Counts are kept per kernel: :func:`launch_count` / :func:`reference_count`
  for the f32 kernel, :func:`tc_launch_count` / :func:`tc_reference_count`
  for the tensor-core kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from blf_tpu_torch.ops.cuda import _build
from blf_tpu_torch.ops.precision import f32_matmuls

__all__ = ["admm_stage", "admm_stage_reference", "launch_count",
           "reference_count", "tc_launch_count", "tc_reference_count",
           "reset_counts", "stage_shared_bytes", "stage_tc_shared_bytes", "tc_lanes",
           "build_admm_stage", "build_admm_stage_tc", "MATMUL_MODES", "SOURCE",
           "REPLACES", "TC_SOURCE", "TC_REPLACES"]

MATMUL_MODES = ("f32", "split", "delta")
SOURCE = "admm_stage.cu"
#: the TPU kernel this one replaces (file:line of ``_stage_kernel_t``)
REPLACES = "blf_tpu/ops/pallas/admm.py:138"
#: the tensor-core kernel of modes "split" and "delta", and what it replaces
TC_SOURCE = "admm_stage_tc.cu"
TC_REPLACES = "blf_tpu/ops/pallas/admm.py:138"

_LANES = 32                 # lanes per block (csrc/admm_stage.cu)
_MAX_SHARED = 232448        # bytes of shared memory a block may use on sm_90

# Plain integers: how often each kernel was launched (the tensor-core one by
# mode), and how often a plain version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0, "tc_split": 0, "tc_delta": 0, "tc_reference": 0}
_libs: Dict[Tuple[int, int], ctypes.CDLL] = {}
_tc_libs: Dict[Tuple[int, int, str], ctypes.CDLL] = {}


def launch_count() -> int:
    """Launches of the f32 kernel since the last :func:`reset_counts`."""
    return _counts["launch"]


def reference_count() -> int:
    """Plain-version runs of mode ``"f32"`` made by :func:`admm_stage` for CPU
    tensors."""
    return _counts["reference"]


def tc_launch_count(matmul: Optional[str] = None) -> int:
    """Launches of the tensor-core kernel, in mode ``matmul`` or in both."""
    if matmul is None:
        return _counts["tc_split"] + _counts["tc_delta"]
    return _counts["tc_" + matmul]


def tc_reference_count() -> int:
    """Plain-version runs of modes ``"split"``/``"delta"`` made by
    :func:`admm_stage` for CPU tensors."""
    return _counts["tc_reference"]


def reset_counts() -> None:
    for key in _counts:
        _counts[key] = 0


def _clip(v, l, u):
    # min(max(v, l), u): passes a NaN of v, l or u on, as jnp.clip does
    return torch.minimum(torch.maximum(v, l), u)


def _bf16(x):
    """``x`` rounded to bf16 (to nearest even), kept in ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _split(x):
    """bf16 hi/lo pair of ``x``: ``hi = bf16(x)``, ``lo = bf16(x - hi)``."""
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _lsplit_dot3(a_pair, b):
    """3-pass product of a split operator (k, out) and ``b`` (B, k), ``b``
    split too: ``A_hi b_hi + A_hi b_lo + A_lo b_hi``, summed in that order."""
    a_hi, a_lo = a_pair
    b_hi, b_lo = _split(b)
    return b_hi @ a_hi + b_lo @ a_hi + b_hi @ a_lo


def _lsplit_dot2(a_pair, b16):
    """2-pass product of a split operator and a bf16-valued increment."""
    a_hi, a_lo = a_pair
    return b16 @ a_hi + b16 @ a_lo


@f32_matmuls
def _reduced_stage_reference(v, s, gq, l, u, G2, d, base_rho, *, iters: int,
                             alpha: float, matmul: str):
    """Modes ``"split"`` and ``"delta"`` (``admm.py:166-255``), lane-major."""
    sdinv = s / (1.0 + s * d)           # (B, n), fixed over the stage
    gqs = gq / s
    gt = _split(base_rho[:, None] * G2)             # (m, n): the reference's Gt_rho, transposed
    g2 = tuple(h.T for h in _split(G2))             # (n, m)
    if matmul == "split":
        for _ in range(iters):
            z = _clip(v, l, u)
            w_hat = 2.0 * z - v
            tau = (_lsplit_dot3(gt, w_hat) - gqs) * sdinv
            v = v + alpha * (_lsplit_dot3(g2, tau) - z)
        return v, tau
    # iteration 1 applies the full w and tau through 3-pass splits; later ones
    # accumulate 2-pass products of the bf16-rounded increments
    z = _clip(v, l, u)
    w_hat = 2.0 * z - v
    t_acc = _lsplit_dot3(gt, w_hat)
    tau = (t_acc - gqs) * sdinv
    u_acc = _lsplit_dot3(g2, tau)
    v = v + alpha * (u_acc - z)
    for _ in range(iters - 1):
        z = _clip(v, l, u)
        w_prev, w_hat = w_hat, 2.0 * z - v
        t_acc = t_acc + _lsplit_dot2(gt, _bf16(w_hat - w_prev))
        tau_prev, tau = tau, (t_acc - gqs) * sdinv
        u_acc = u_acc + _lsplit_dot2(g2, _bf16(tau - tau_prev))
        v = v + alpha * (u_acc - z)
    return v, tau


def admm_stage_reference(v, tau, s, gq, l, u, G2, d, base_rho, *,
                         iters: int, alpha: float, matmul: str = "f32"):
    """Plain PyTorch version of the stage (any device).

    Shapes: ``v, l, u`` (B, m); ``tau, gq`` (B, n); ``s`` (B, 1); ``G2``
    (m, n); ``d`` (n,); ``base_rho`` (m,). Returns ``(v, tau)``. ``tau`` on
    entry does not feed the recursion (it is overwritten by the first
    iteration) and is accepted for symmetry with the reference's signature.
    ``"f32"`` takes any float dtype; ``"split"`` and ``"delta"`` round to bf16
    as the reference does and are meant for float32.
    """
    if matmul not in MATMUL_MODES:
        raise ValueError(f"unknown matmul mode {matmul!r}; expected one of {MATMUL_MODES}")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if matmul != "f32":
        return _reduced_stage_reference(v, s, gq, l, u, G2, d, base_rho, iters=iters,
                                        alpha=alpha, matmul=matmul)
    sdinv = s / (1.0 + s * d)           # (B, n), fixed over the stage
    gqs = gq / s
    G2t = G2.T
    for _ in range(iters):
        z = _clip(v, l, u)
        w = base_rho * (2.0 * z - v)
        tau = (w @ G2 - gqs) * sdinv
        v = v + alpha * (tau @ G2t - z)
    return v, tau


def stage_shared_bytes(m: int, n: int) -> int:
    """Shared memory one block of the f32 kernel needs at shape ``(m, n)``
    (csrc/admm_stage.cu): the operator, rows padded by 4 floats, and a
    32-lane tile's bounds, w, tau and the partial sums its two halves hand
    each other."""
    return 4 * (m * (n + 4) + 3 * m * _LANES + n * _LANES + max(m, n) * _LANES)


def _check_shape(m: int, n: int) -> None:
    if n % 4 != 0 or n < 4 or m < 1:
        raise ValueError(
            f"admm_stage kernel needs n to be a positive multiple of 4, got"
            f" (m, n) = ({m}, {n})")
    need = stage_shared_bytes(m, n)
    if need > _MAX_SHARED:
        raise ValueError(
            f"admm_stage kernel keeps the operator and a {_LANES}-lane tile in"
            f" shared memory: (m, n) = ({m}, {n}) needs {need} bytes, the card"
            f" offers {_MAX_SHARED}")


def build_admm_stage(m: int, n: int) -> ctypes.CDLL:
    """Build (at first use) and load the f32 kernel's library for ``(m, n)``."""
    lib = _libs.get((m, n))
    if lib is not None:
        return lib
    _check_shape(m, n)
    lib = _build.load_library(SOURCE, {"ADMM_M": m, "ADMM_N": n})
    P = ctypes.c_void_p
    lib.blf_admm_stage_f32.argtypes = [P] * 10 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, P]
    lib.blf_admm_stage_f32.restype = ctypes.c_int
    lib.blf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_admm_stage_smem_bytes.argtypes = []
    lib.blf_admm_stage_smem_bytes.restype = ctypes.c_int
    if lib.blf_admm_stage_smem_bytes() != stage_shared_bytes(m, n):
        raise RuntimeError("admm_stage library disagrees with its wrapper on"
                           " the shared-memory layout")
    _libs[(m, n)] = lib
    return lib


def tc_lanes(m: int, n: int) -> int:
    """Lanes of a tile of the tensor-core kernel at ``(m, n)`` (wgmma's N):
    32 where the operator has more than one 64-row tile, so that each of the
    block's warpgroups owns one; 16 for an operator of one row tile each way,
    whose latency-bound stage wants more blocks in flight."""
    return 32 if m > 64 else 16


def stage_tc_shared_bytes(m: int, n: int, matmul: str) -> int:
    """Shared memory one block of the tensor-core kernel needs at ``(m, n)``
    (csrc/admm_stage_tc.cu), the same in both modes: both bf16 operator
    pairs, rows padded to 64 and the contraction to 16, and the operand
    buffers of one tile of :func:`tc_lanes` lanes (w's hi and lo, tau's hi)."""
    up = lambda x, k: -(-x // k) * k
    k1, k2, lanes = up(m, 16), up(n, 16), tc_lanes(m, n)
    operators = 2 * (2 * up(n, 64) * k1 + 2 * up(m, 64) * k2)
    return operators + 2 * lanes * (2 * k1 + k2)


def _check_tc_shape(m: int, n: int, matmul: str) -> None:
    need = stage_tc_shared_bytes(m, n, matmul)
    if m < 1 or n < 1 or need > _MAX_SHARED:
        raise ValueError(
            f"admm_stage_tc keeps both bf16 operator pairs and a {tc_lanes(m, n)}-lane"
            f" tile's operand buffers in shared memory: (m, n) = ({m}, {n}) needs {need}"
            f" bytes in mode {matmul!r}, the card offers {_MAX_SHARED}")
    if n > m or m > 192:
        raise ValueError(
            f"admm_stage_tc gives each 64-row tile of G2 (m, n) a warpgroup, at most"
            f" three, and needs n <= m: (m, n) = ({m}, {n})")


def build_admm_stage_tc(m: int, n: int, matmul: str) -> ctypes.CDLL:
    """Build (at first use) and load the tensor-core kernel for ``(m, n)`` in
    mode ``"split"`` or ``"delta"``."""
    if matmul not in ("split", "delta"):
        raise ValueError(f"the tensor-core kernel runs modes 'split' and 'delta', not {matmul!r}")
    lib = _tc_libs.get((m, n, matmul))
    if lib is not None:
        return lib
    _check_tc_shape(m, n, matmul)
    lib = _build.load_library(TC_SOURCE, tc_defines(m, n, matmul))
    P = ctypes.c_void_p
    lib.blf_admm_stage_tc.argtypes = [P] * 10 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, P]
    lib.blf_admm_stage_tc.restype = ctypes.c_int
    lib.blf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_admm_stage_tc_smem_bytes.argtypes = []
    lib.blf_admm_stage_tc_smem_bytes.restype = ctypes.c_int
    if lib.blf_admm_stage_tc_smem_bytes() != stage_tc_shared_bytes(m, n, matmul):
        raise RuntimeError("admm_stage_tc library disagrees with its wrapper on"
                           " the shared-memory layout")
    _tc_libs[(m, n, matmul)] = lib
    return lib


def tc_defines(m: int, n: int, matmul: str) -> Dict[str, int]:
    """Compile-time definitions of the tensor-core kernel's library."""
    return {"ADMM_M": m, "ADMM_N": n, "ADMM_DELTA": int(matmul == "delta"),
            "ADMM_LANES": tc_lanes(m, n)}


def _require(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"admm_stage kernel is float32 only; {name} is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def admm_stage(v, tau, s, gq, l, u, G2, d, base_rho, *, iters: int, alpha: float,
               matmul: str = "f32"):
    """Run ``iters`` fused ADMM iterations; returns new ``(v, tau)``.

    CPU tensors go through :func:`admm_stage_reference`. CUDA tensors must be
    contiguous float32 of the documented shapes; the mode's kernel is launched
    on the current stream, its launch error is checked, and the call does not
    synchronise. Any ``B >= 1`` is taken (the kernels mask their last tile).
    ``"split"`` and ``"delta"`` take float32 only, on either device.
    """
    if matmul not in MATMUL_MODES:
        raise ValueError(f"unknown matmul mode {matmul!r}; expected one of {MATMUL_MODES}")
    if iters < 1:
        raise ValueError("iters must be >= 1")
    reduced = matmul != "f32"
    if reduced and v.dtype != torch.float32:
        raise TypeError(f"admm_stage matmul={matmul!r} is float32 only; v is {v.dtype}")
    if v.device.type == "cpu":
        _counts["tc_reference" if reduced else "reference"] += 1
        return admm_stage_reference(v, tau, s, gq, l, u, G2, d, base_rho,
                                    iters=iters, alpha=alpha, matmul=matmul)
    if v.device.type != "cuda":
        raise ValueError(f"admm_stage runs on cpu or cuda tensors, not {v.device}")
    if v.dim() != 2 or G2.dim() != 2:
        raise ValueError("v must be (B, m) and G2 (m, n)")
    B, m = v.shape
    n = G2.shape[1]
    if B < 1:
        raise ValueError("admm_stage needs at least one lane")
    dev = v.device
    _require(v, "v", (B, m), dev)
    _require(tau, "tau", (B, n), dev)
    _require(s, "s", (B, 1), dev)
    _require(gq, "gq", (B, n), dev)
    _require(l, "l", (B, m), dev)
    _require(u, "u", (B, m), dev)
    _require(G2, "G2", (m, n), dev)
    _require(d, "d", (n,), dev)
    _require(base_rho, "base_rho", (m,), dev)
    v_out = torch.empty_like(v)
    tau_out = torch.empty_like(tau)
    if reduced:
        lib = build_admm_stage_tc(m, n, matmul)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.blf_admm_stage_tc(
                v.data_ptr(), s.data_ptr(), gq.data_ptr(), l.data_ptr(),
                u.data_ptr(), G2.data_ptr(), d.data_ptr(), base_rho.data_ptr(),
                v_out.data_ptr(), tau_out.data_ptr(), B, m, n, int(matmul == "delta"),
                int(iters), float(alpha), stream)
        _raise_on(code, lib, "admm_stage_tc")
        _counts["tc_" + matmul] += 1
        return v_out, tau_out
    if G2.data_ptr() % 16:
        raise ValueError("G2 must be 16-byte aligned")
    lib = build_admm_stage(m, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.blf_admm_stage_f32(
            v.data_ptr(), s.data_ptr(), gq.data_ptr(), l.data_ptr(),
            u.data_ptr(), G2.data_ptr(), d.data_ptr(), base_rho.data_ptr(),
            v_out.data_ptr(), tau_out.data_ptr(), B, m, n, int(iters),
            float(alpha), stream)
    _raise_on(code, lib, "admm_stage")
    _counts["launch"] += 1
    return v_out, tau_out


def _raise_on(code: int, lib: ctypes.CDLL, name: str) -> None:
    if code != 0:
        what = (lib.blf_cuda_error_string(code).decode() if code > 0
                else {-1: "library compiled for another shape or mode",
                      -2: "bad batch or iteration count"}.get(code, "?"))
        raise RuntimeError(f"{name} launch failed ({code}): {what}")
