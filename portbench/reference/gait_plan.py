"""Plain reference of one full-gait plan over a batch of initial DCMs.

From the configuration's stance windows it redoes, in float64: the knots'
active feet (a foot is in stance at ``t`` when one of its windows holds
``on <= t < off``), each knot's support polygon (the convex hull of the
active feet's corner points, as unit outward normals and offsets, padded
with ``0 z <= 1`` rows), the ZMP reference (the centroid of the active
feet) and the DCM reference (the backward recursion ``xi_k = z_k +
e^{-w dt} (xi_{k+1} - z_k)`` from the last ZMP reference), then the
transcription, the factorization and the cold-started ADMM solve of
:mod:`portbench.reference.admm`. Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import admm

__all__ = ["Problem", "prepare", "plan", "Plan", "hull", "support"]


def hull(points: np.ndarray) -> np.ndarray:
    """Counter-clockwise convex hull of 2-D points (Andrew's monotone chain),
    collinear points dropped."""
    pts = sorted(set(map(tuple, np.round(points, 15))))
    if len(pts) <= 2:
        return np.array(pts)
    cross = lambda o, a, b: (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.array(lower[:-1] + upper[:-1])


def support(points: np.ndarray, rows: int):
    """Half-spaces ``n . z <= b`` of the hull's edges, unit outward normals,
    padded to ``rows`` with ``0 . z <= 1``."""
    v = hull(points)
    e = np.roll(v, -1, axis=0) - v
    normal = np.stack([e[:, 1], -e[:, 0]], axis=1) / np.linalg.norm(e, axis=1)[:, None]
    A = np.zeros((rows, 2))
    b = np.ones(rows)
    A[:len(v)] = normal
    b[:len(v)] = (normal * v).sum(axis=1)
    return A, b


class Problem(NamedTuple):
    config: dict
    settings: admm.QPSettings
    a: float
    N: int
    zmp_ref: np.ndarray
    dcm_ref: np.ndarray
    poly_A: np.ndarray         # (N, F, 2)
    poly_b: np.ndarray         # (N, F)
    P: np.ndarray
    q: np.ndarray
    A: np.ndarray
    b: np.ndarray
    factors: admm.Factors


def prepare(config: dict) -> Problem:
    """Schedule, polygons, references, transcription and factorization."""
    dt = float(config["dt"])
    windows = [ws for _, ws in sorted(config["footsteps"].items())]
    last = max(w[4] for ws in windows for w in ws)
    N = int(round(last / dt))
    times = dt * np.arange(N)
    hl, hw = float(config["foot_half_length"]), float(config["foot_half_width"])
    corners = np.array([[hl, hw], [hl, -hw], [-hl, hw], [-hl, -hw]])
    F = int(config["max_halfspaces"])
    poly_A, poly_b = np.zeros((N, F, 2)), np.zeros((N, F))
    zmp_ref = np.zeros((N, 2))
    for k, t in enumerate(times):
        feet = [np.array(w[:2], float) for ws in windows for w in ws if w[3] <= t < w[4]]
        if not feet:
            raise ValueError(f"knot {k} has no foot in stance")
        poly_A[k], poly_b[k] = support(np.concatenate([f + corners for f in feet]), F)
        zmp_ref[k] = np.mean(feet, axis=0)
    w = np.sqrt(config["gravity"] / config["com_height"])
    back = np.exp(-w * dt)
    dcm_ref = np.zeros((N + 1, 2))
    dcm_ref[N] = zmp_ref[-1]
    for k in range(N - 1, -1, -1):
        dcm_ref[k] = zmp_ref[k] + back * (dcm_ref[k + 1] - zmp_ref[k])
    a = admm.zoh_gain(config["com_height"], config["gravity"], dt)
    P, q, A, b, is_eq = admm.transcribe(a, config["weights"], dcm_ref, zmp_ref, poly_A, poly_b)
    st = admm.QPSettings.of(config)
    return Problem(config, st, a, N, zmp_ref, dcm_ref, poly_A, poly_b, P, q, A, b,
                   admm.factor(P, A, is_eq, st))


class Plan(NamedTuple):
    dcm: torch.Tensor          # (B, N+1, 2), xi_0 first
    zmp: torch.Tensor          # (B, N, 2)
    converged: torch.Tensor    # (B,) bool


def plan(pb: Problem, dcm0: torch.Tensor, precision: str = "float64") -> Plan:
    """Plan every lane from its initial DCM ``dcm0`` (B, 2), cold-started."""
    dt = torch.float64 if precision == "float64" else torch.float32
    N = pb.N
    dcm0 = dcm0.to(dt)
    l, u = admm.lane_bounds(pb.a, dcm0, N, torch.as_tensor(pb.b, device=dcm0.device))
    sol = admm.solve(pb.factors, pb.P, pb.A, pb.q, l, u, pb.settings,
                     int(pb.config["iterations"]), precision=precision)
    zmp = torch.stack([sol.x[:, 2 * N:3 * N], sol.x[:, 3 * N:]], dim=-1)
    xi = torch.stack([sol.x[:, :N], sol.x[:, N:2 * N]], dim=-1)
    return Plan(torch.cat([dcm0[:, None], xi], dim=1), zmp, sol.converged)
