"""Fused shared-operator ADMM stage: CUDA kernel wrapper and plain version.

Counterpart of ``blf_tpu/ops/pallas/admm.py`` (``admm_stage`` /
``admm_stage_t`` over ``_stage_kernel_t``, ``matmul="f32"``). One call runs
``iters`` iterations, at a fixed per-lane penalty multiplier ``s``, of the
v-space recursion of :func:`blf_tpu_torch.mpc.qp.solve_qp_factored`::

    z   = clip(v, l, u)
    w   = rho * (2 z - v)
    tau = (w @ G2 - gq / s) * s / (1 + s d)
    v  += alpha (tau @ G2.T - z)

Layout is lane-major, ``(B, .)``, at the public boundary and inside the
kernel's device-memory traffic; the batch-minor transpose, the 128-lane
padding, ``block_lanes``/``chunks``/``unroll``/``interpret`` and the VMEM
guard of the reference are TPU matters and have no counterpart here.

- :func:`admm_stage_reference` is the plain PyTorch loop, any float dtype.
- :func:`admm_stage` runs the plain loop for tensors that lie on the CPU and
  launches the hand-written kernel ``csrc/admm_stage.cu`` for CUDA tensors.
  There it launches or raises: nothing falls back.

Not ported from the reference module: the reduced-precision ``"delta"`` and
``"split"`` modes (bf16 hi/lo passes for the TPU's matrix unit). Their
tensor-core counterparts are a later kernel (see ROADMAP.md, "K1
follow-ups").
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from blf_tpu_torch.ops.cuda import _build

__all__ = ["admm_stage", "admm_stage_reference", "launch_count",
           "reference_count", "reset_counts", "stage_shared_bytes",
           "build_admm_stage", "SOURCE", "REPLACES"]

SOURCE = "admm_stage.cu"
#: the TPU kernel this one replaces (file:line of ``_stage_kernel_t``)
REPLACES = "blf_tpu/ops/pallas/admm.py:138"

_LANES = 32                 # lanes per block (csrc/admm_stage.cu)
_MAX_SHARED = 232448        # bytes of shared memory a block may use on sm_90

# Plain integers: how often the kernel was launched, and how often the plain
# version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0}
_libs: Dict[Tuple[int, int], ctypes.CDLL] = {}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_counts`."""
    return _counts["launch"]


def reference_count() -> int:
    """Plain-version runs made by :func:`admm_stage` for CPU tensors."""
    return _counts["reference"]


def reset_counts() -> None:
    _counts["launch"] = 0
    _counts["reference"] = 0


def _clip(v, l, u):
    # min(max(v, l), u): passes a NaN of v, l or u on, as jnp.clip does
    return torch.minimum(torch.maximum(v, l), u)


def admm_stage_reference(v, tau, s, gq, l, u, G2, d, base_rho, *,
                         iters: int, alpha: float):
    """Plain PyTorch version of the stage (any float dtype, any device).

    Shapes: ``v, l, u`` (B, m); ``tau, gq`` (B, n); ``s`` (B, 1); ``G2``
    (m, n); ``d`` (n,); ``base_rho`` (m,). Returns ``(v, tau)``. ``tau`` on
    entry does not feed the recursion (it is overwritten by the first
    iteration) and is accepted for symmetry with the reference's signature.
    """
    if iters < 1:
        raise ValueError("iters must be >= 1")
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
    """Shared memory one block of the kernel needs at shape ``(m, n)``."""
    return 4 * (m * (n + 4) + 3 * m * _LANES + n * _LANES)


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
    """Build (at first use) and load the kernel library for shape ``(m, n)``."""
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


def _require(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"admm_stage kernel is float32 only; {name} is {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def admm_stage(v, tau, s, gq, l, u, G2, d, base_rho, *, iters: int, alpha: float):
    """Run ``iters`` fused ADMM iterations; returns new ``(v, tau)``.

    CPU tensors go through :func:`admm_stage_reference`. CUDA tensors must be
    contiguous float32 of the documented shapes; the kernel is launched on the
    current stream, its launch error is checked, and the call does not
    synchronise. Any ``B >= 1`` is taken (the kernel masks its last tile).
    """
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if v.device.type == "cpu":
        _counts["reference"] += 1
        return admm_stage_reference(v, tau, s, gq, l, u, G2, d, base_rho,
                                    iters=iters, alpha=alpha)
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
    if G2.data_ptr() % 16:
        raise ValueError("G2 must be 16-byte aligned")
    lib = build_admm_stage(m, n)
    v_out = torch.empty_like(v)
    tau_out = torch.empty_like(tau)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.blf_admm_stage_f32(
            v.data_ptr(), s.data_ptr(), gq.data_ptr(), l.data_ptr(),
            u.data_ptr(), G2.data_ptr(), d.data_ptr(), base_rho.data_ptr(),
            v_out.data_ptr(), tau_out.data_ptr(), B, m, n, int(iters),
            float(alpha), stream)
    if code != 0:
        what = (lib.blf_cuda_error_string(code).decode() if code > 0
                else {-1: "library compiled for another shape",
                      -2: "bad batch or iteration count"}.get(code, "?"))
        raise RuntimeError(f"admm_stage launch failed ({code}): {what}")
    _counts["launch"] += 1
    return v_out, tau_out
