"""Plain reference of one push-recovery fleet tick.

From a fleet state and the tick's pushes it redoes, in float64 (or as the
control, see :mod:`portbench.reference.admm`): the ensemble-perturbed
initial DCMs (member k of scenario b on lane ``b K + k``), the warm start
rolled out from the previous plan, the transcription, the factorization,
the ADMM solve, the consensus plan (the mean over the K members), the true
state's advance under its first knot and the mean push, the RLS update of
the unmodelled DCM disturbance (regressor I), the per-scenario status (the
worst member: 0 converged, 1 not converged, 2 non-finite) and the reset of
non-finite scenarios. Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import admm

__all__ = ["TickInput", "TickOutput", "Problem", "prepare", "tick"]


class TickInput(NamedTuple):
    """A fleet state (B scenarios) and the tick's pushes ``(B, K, 2)``."""

    dcm: torch.Tensor
    com: torch.Tensor
    warm_zmp: torch.Tensor     # (B, N, 2)
    warm_y: torch.Tensor       # (B, M)
    theta: torch.Tensor        # (B, 2)
    cov: torch.Tensor          # (B, 2, 2)
    warm_s: torch.Tensor       # (B, 1)
    push: torch.Tensor         # (B, K, 2)


class TickOutput(NamedTuple):
    zmp0: torch.Tensor         # (B, 2) first knot of the consensus plan
    status: torch.Tensor       # (B,) int
    converged: torch.Tensor    # (B, K) bool, each member's solve
    dcm: torch.Tensor
    com: torch.Tensor
    theta: torch.Tensor
    cov: torch.Tensor
    warm_zmp: torch.Tensor
    warm_y: torch.Tensor
    warm_s: torch.Tensor


class Problem(NamedTuple):
    config: dict
    settings: admm.QPSettings
    a: float
    N: int
    P: np.ndarray
    q: np.ndarray
    A: np.ndarray
    b: np.ndarray
    factors: admm.Factors


def prepare(config: dict) -> Problem:
    """The lane-shared transcription and its factorization, from the
    configuration alone (references at the origin, one support box)."""
    N = int(config["horizon"])
    a = admm.zoh_gain(config["com_height"], config["gravity"], config["dt"])
    box_A = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    poly_A = np.broadcast_to(box_A, (N, 4, 2))
    poly_b = np.broadcast_to(np.asarray(config["support_box"], float), (N, 4))
    P, q, A, b, is_eq = admm.transcribe(a, config["weights"], np.zeros((N + 1, 2)),
                                        np.zeros((N, 2)), poly_A, poly_b)
    st = admm.QPSettings.of(config)
    return Problem(config, st, a, N, P, q, A, b, admm.factor(P, A, is_eq, st))


def tick(pb: Problem, inp: TickInput, precision: str = "float64") -> TickOutput:
    dt = torch.float64 if precision == "float64" else torch.float32
    cfg, N, a = pb.config, pb.N, pb.a
    f = lambda t: t.to(dt)
    dcm, com, theta, cov, push = f(inp.dcm), f(inp.com), f(inp.theta), f(inp.cov), f(inp.push)
    B, K = push.shape[0], push.shape[1]
    per_lane = lambda t: t.to(dt).repeat_interleave(K, 0)
    dcm0 = (dcm[:, None] + push + theta[:, None]).reshape(B * K, 2)
    warm = per_lane(inp.warm_zmp)
    xi, xis = dcm0, []
    for k in range(N):
        xi = a * xi + (1.0 - a) * warm[:, k]
        xis.append(xi)
    xi = torch.stack(xis, dim=1)
    x0 = torch.cat([xi[..., 0], xi[..., 1], warm[..., 0], warm[..., 1]], dim=1)
    l, u = admm.lane_bounds(a, dcm0, N, torch.as_tensor(pb.b, device=dcm0.device))
    sol = admm.solve(pb.factors, pb.P, pb.A, pb.q, l, u, pb.settings,
                     int(cfg["iterations"]), x0=x0, y0=per_lane(inp.warm_y),
                     s0=per_lane(inp.warm_s), precision=precision)
    zmp = torch.stack([sol.x[:, 2 * N:3 * N], sol.x[:, 3 * N:]], dim=-1)   # (BK, N, 2)
    members = lambda t: t.reshape((B, K) + t.shape[1:])
    zmp_c = members(zmp).mean(1)
    y_c = members(sol.y).mean(1)
    s_c = members(sol.s).mean(1)
    push_c = push.mean(1)
    z0 = zmp_c[:, 0]
    dcm_next = a * dcm + (1.0 - a) * z0 + push_c
    w = float(np.sqrt(cfg["gravity"] / cfg["com_height"]))
    em, ep = float(np.exp(-w * cfg["dt"])), float(np.exp(w * cfg["dt"]))
    com_next = z0 + em * (com - z0) + 0.5 * (ep - em) * (dcm - z0)
    # RLS with regressor I: S = lam R + C, K = C S^-1
    lam = float(cfg["rls"]["lambda"])
    R = float(cfg["rls"]["meas_noise"]) * torch.eye(2, dtype=dt, device=dcm.device)
    gain = torch.linalg.solve(lam * R + cov, cov).transpose(-1, -2)
    meas = dcm_next - (a * dcm + (1.0 - a) * z0) - push_c
    theta_next = theta + (gain @ (meas - theta)[..., None])[..., 0]
    cov_next = (cov - gain @ cov) / lam
    cov_next = 0.5 * (cov_next + cov_next.transpose(-1, -2))
    finite = torch.isfinite(sol.x).all(-1) & torch.isfinite(sol.primal_residual) \
        & torch.isfinite(sol.dual_residual)
    lane_status = torch.where(finite, torch.where(sol.converged, 0, 1), 2)
    status = members(lane_status).amax(1)
    bad = status == 2
    keep = lambda new, old: torch.where(bad.reshape((B,) + (1,) * (new.dim() - 1)), old, new)
    zero = torch.zeros((), dtype=dt, device=dcm.device)
    return TickOutput(
        zmp0=z0, status=status, converged=members(sol.converged),
        dcm=keep(dcm_next, torch.nan_to_num(dcm, 0.0, 0.0, 0.0)),
        com=keep(com_next, torch.nan_to_num(com, 0.0, 0.0, 0.0)),
        theta=keep(theta_next, zero), cov=keep(cov_next, 10.0 * torch.eye(2, dtype=dt,
                                                                        device=dcm.device)),
        warm_zmp=keep(zmp_c, zero), warm_y=keep(y_c, zero), warm_s=keep(s_c, zero + 1.0))
