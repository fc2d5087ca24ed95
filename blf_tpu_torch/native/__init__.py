"""Native host runtime: C++ batch schedule lowering + hulls via ctypes.

Counterpart of ``blf_tpu/native/__init__.py``, with the same four functions
and options (``available``, ``lower_schedules_batch``, ``monotone_chain``,
``support_polygons_batch``, ``force_python=``) over the port's own copy of
``schedule.cpp``. It is host code: numpy arrays in, numpy arrays out.

The library is compiled at first use with the system ``g++`` (``-O3
-std=c++17 -shared -fPIC``, the reference's flags) into
``blf_tpu_torch/_build/``, named by a hash of the source and the flags, and
never at import. Where the build fails the functions take their numpy
versions, as the reference's do; unlike the reference the loader says so:

- :func:`available` is falsy and carries the compiler's output in its
  ``reason``;
- every run of a numpy version is counted (:func:`python_count`), so that a
  caller can show that a path ran natively.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

from blf_tpu_torch._paths import BUILD_DIR

__all__ = [
    "available",
    "Availability",
    "lower_schedules_batch",
    "monotone_chain",
    "support_polygons_batch",
    "python_count",
    "native_count",
    "reset_counts",
    "library_path",
    "GXX_FLAGS",
]

_SRC = os.path.join(os.path.dirname(__file__), "schedule.cpp")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_REASON: Optional[str] = None      # None: not tried yet; "": built and loaded

# Plain integers: calls that ran the C++ library, and runs of a numpy version
# (asked for with force_python=True, or because the library is unavailable).
_counts = {"native": 0, "python": 0}


class Availability(NamedTuple):
    """What :func:`available` reports: truthy iff the library loaded;
    ``reason`` says why not (the compiler's command and output)."""

    ok: bool
    reason: str

    def __bool__(self) -> bool:
        return self.ok


def python_count() -> int:
    """Runs of a numpy version since the last :func:`reset_counts`."""
    return _counts["python"]


def native_count() -> int:
    """Calls served by the C++ library since the last :func:`reset_counts`."""
    return _counts["native"]


def reset_counts() -> None:
    for key in _counts:
        _counts[key] = 0


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return str(BUILD_DIR / f"libblf_native_{h.hexdigest()[:16]}.so")


def _build() -> Tuple[Optional[ctypes.CDLL], str]:
    """Compile (unless an up-to-date library exists) and load the library;
    returns it, or None and the reason."""
    lib_path = library_path()
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = lib_path + f".build{os.getpid()}"
        cmd = ["g++", *GXX_FLAGS, "-o", tmp, _SRC]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as exc:
            return None, f"$ {' '.join(cmd)}\n{exc!r}"
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None, (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                          f"[exit {proc.returncode}]")
        os.replace(tmp, lib_path)   # atomic: a concurrent process never loads half a file
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as exc:
        return None, f"loading {lib_path} failed: {exc}"
    P, I32, F64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_double
    lib.blf_lower_schedule.argtypes = [P] * 4 + [I32] * 4 + [F64] * 2 + [P] * 3
    lib.blf_lower_schedule.restype = None
    lib.blf_monotone_chain.argtypes = [P, I32, P]
    lib.blf_monotone_chain.restype = I32
    lib.blf_support_polygons.argtypes = [P] * 3 + [I32] * 4 + [P] * 2
    lib.blf_support_polygons.restype = None
    return lib, ""


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _REASON
    with _lock:
        if _REASON is None:
            _LIB, _REASON = _build()
        return _LIB


def available() -> Availability:
    """Whether the native library compiled and loaded (builds it at first
    call); falsy with the compiler's output as ``reason`` if not."""
    lib = _lib()
    return Availability(lib is not None, _REASON or "")


def _c(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _serve(force_python: bool) -> Optional[ctypes.CDLL]:
    """The library for this call, counted; None (counted as a numpy run) if
    the caller forces the numpy version or the library is unavailable."""
    lib = None if force_python else _lib()
    _counts["python" if lib is None else "native"] += 1
    return lib


# ---------------------------------------------------------------------------
# Batch schedule lowering
# ---------------------------------------------------------------------------

def lower_schedules_batch(
    activation: np.ndarray,     # (B, E, C) padded; sort by activation
    deactivation: np.ndarray,   # (B, E, C)
    counts: np.ndarray,         # (B, E) int32 — real windows per list
    positions: np.ndarray,      # (B, E, C, 3)
    horizon: int,
    dt: float,
    t0: float = 0.0,
    *,
    force_python: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense lowering of B×E contact lists — the batched equivalent of
    :func:`blf_tpu_torch.planners.contacts.lower_contact_schedule` (positions
    only; rotations stay identity in the batch path).

    Returns (active (B,E,T) bool, index (B,E,T) int32, pos (B,E,T,3)).
    """
    B, E, C = activation.shape
    T = int(horizon)
    activation = np.ascontiguousarray(activation, dtype=np.float64)
    deactivation = np.ascontiguousarray(deactivation, dtype=np.float64)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    positions = np.ascontiguousarray(positions, dtype=np.float64)

    lib = _serve(force_python)
    if lib is not None:
        active = np.empty((B, E, T), dtype=np.uint8)
        index = np.empty((B, E, T), dtype=np.int32)
        pos = np.empty((B, E, T, 3), dtype=np.float64)
        lib.blf_lower_schedule(
            _c(activation), _c(deactivation), _c(counts), _c(positions),
            ctypes.c_int32(B), ctypes.c_int32(E), ctypes.c_int32(C),
            ctypes.c_int32(T), ctypes.c_double(dt), ctypes.c_double(t0),
            _c(active), _c(index), _c(pos),
        )
        return active.astype(bool), index, pos

    # numpy version (identical semantics)
    times = t0 + dt * np.arange(T)
    active = np.zeros((B, E, T), dtype=bool)
    index = np.full((B, E, T), -1, dtype=np.int32)
    pos = np.zeros((B, E, T, 3), dtype=np.float64)
    for b in range(B):
        for e in range(E):
            n = counts[b, e]
            if n == 0:
                continue
            acts, deacts = activation[b, e, :n], deactivation[b, e, :n]
            idx = np.searchsorted(acts, times, side="right") - 1
            index[b, e] = idx
            present = idx >= 0
            active[b, e] = present & (times < deacts[np.clip(idx, 0, None)])
            pos[b, e] = positions[b, e, np.where(present, idx, 0)]
    return active, index, pos


def monotone_chain(points: np.ndarray, *, force_python: bool = False) -> np.ndarray:
    """2-D convex hull (CCW, collinear dropped) of (n, 2) points."""
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = len(pts)
    lib = _serve(force_python or not n)
    if lib is not None:
        out = np.empty((2 * n + 2, 2), dtype=np.float64)
        k = lib.blf_monotone_chain(_c(pts), ctypes.c_int32(n), _c(out))
        return out[:k].copy()
    from scipy.spatial import ConvexHull  # Qhull, as the reference's fall-back

    if n < 3:
        return np.unique(pts, axis=0)
    hull = ConvexHull(pts)
    return pts[hull.vertices]


def support_polygons_batch(
    active: np.ndarray,      # (B, E, T) bool
    foot_xy: np.ndarray,     # (B, E, T, 2)
    half_length: float,
    half_width: float,
    max_halfspaces: int = 8,
    *,
    force_python: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-(scenario, knot) ZMP support polygons as padded half-spaces
    (batched host counterpart of
    :func:`blf_tpu_torch.planners.gait.support_polygons`).

    Returns (A (B,T,F,2), b (B,T,F)); padding rows are ``0·x ≤ 1``.
    """
    B, E, T = active.shape
    F = int(max_halfspaces)
    corners = np.array(
        [[half_length, half_width], [half_length, -half_width],
         [-half_length, half_width], [-half_length, -half_width]],
        dtype=np.float64,
    )
    active8 = np.ascontiguousarray(active, dtype=np.uint8)
    foot_xy = np.ascontiguousarray(foot_xy, dtype=np.float64)

    lib = _serve(force_python)
    if lib is not None:
        A = np.empty((B, T, F, 2), dtype=np.float64)
        b = np.empty((B, T, F), dtype=np.float64)
        lib.blf_support_polygons(
            _c(active8), _c(foot_xy), _c(corners),
            ctypes.c_int32(B), ctypes.c_int32(E), ctypes.c_int32(T),
            ctypes.c_int32(F), _c(A), _c(b),
        )
        return A, b

    A = np.zeros((B, T, F, 2))
    b = np.ones((B, T, F))
    for bb in range(B):
        for t in range(T):
            pts = [
                foot_xy[bb, e, t] + corners
                for e in range(E) if active[bb, e, t]
            ]
            if not pts:
                if t > 0:
                    A[bb, t], b[bb, t] = A[bb, t - 1], b[bb, t - 1]
                continue
            # as in the reference: the hull of each knot asks for the library
            hull = monotone_chain(np.concatenate(pts), force_python=False)
            k = min(len(hull), F)
            for i in range(k):
                v, w = hull[i], hull[(i + 1) % len(hull)]
                e_vec = w - v
                nrm = np.hypot(*e_vec)
                if nrm < 1e-300:
                    continue
                n_hat = np.array([e_vec[1], -e_vec[0]]) / nrm
                A[bb, t, i] = n_hat
                b[bb, t, i] = n_hat @ v
    return A, b
