"""Gait planning: footstep schedules -> support polygons -> DCM-MPC inputs.

Counterpart of ``blf_tpu/planners/gait.py``; everything of it is ported. The
composition layer for BASELINE config 3 ("TimeVaryingDCMPlanner full gait:
10-step footstep sequence with ConvexHullHelper ZMP constraints"):

1. :func:`footstep_plan` authors an alternating-foot contact schedule with
   the reference-semantics :class:`blf_tpu_torch.planners.contacts.ContactList`
   (numpy, host);
2. :func:`lower_contact_schedule` turns it into dense per-knot masks and
   footholds (numpy, host);
3. :func:`support_polygons` runs the batched monotone-chain hull over the
   active feet's corner points of every knot at once (the reference ``vmap``s
   it over knots) -> padded half-spaces, with the reference's host-side
   fix-up of flight knots;
4. :func:`plan_gait` builds ZMP/DCM references and solves the DCM-MPC over
   the whole gait horizon with :func:`blf_tpu_torch.mpc.dcm.solve_dcm_mpc`,
   passing ``shared=`` and ``backend=`` (among its ``qp_kwargs``) through.

Tensors are made on the device and in the dtype of the pendulum parameters
(``params``), the working dtype: the reference works in JAX's default float
and casts the initial state to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from blf_tpu_torch.models.lipm import LIPMParams, dcm_backward_recursion
from blf_tpu_torch.mpc.dcm import DCMPlan, DCMWeights, solve_dcm_mpc
from blf_tpu_torch.planners.contacts import (ContactList, ContactScheduleArrays,
                                             lower_contact_schedule)
from blf_tpu_torch.planners.convex_hull import (halfspaces_from_polygon,
                                                monotone_chain_2d)
from blf_tpu_torch.utils.device import resolve_device, resolve_dtype
from blf_tpu_torch.utils.profiling import trace

__all__ = ["footstep_plan", "support_polygons", "gait_references", "plan_gait",
           "gait_horizon", "SPANS"]

#: the spans of :func:`plan_gait` (:func:`blf_tpu_torch.utils.profiling.trace`):
#: ``gait.plan`` (the root) around the whole plan, then the schedule, the
#: hulls and the references, and the transcription, factorization, solve and
#: rollout inside it (``mpc/dcm.py``'s and ``mpc/qp.py``'s spans);
#: ``sync.h2d`` around each copy from the host that waits for the device
SPANS = ("gait.plan", "gait.schedule", "gait.hulls", "gait.references", "sync.h2d")


def footstep_plan(
    num_steps: int = 10,
    step_length: float = 0.15,
    step_width: float = 0.2,
    step_duration: float = 0.8,
    double_support: float = 0.2,
    start_position=(0.0, 0.0),
) -> dict:
    """Author an alternating left/right footstep schedule.

    Both feet start in stance; each step swings one foot forward by
    ``step_length`` (feet laterally separated by ``step_width``). Returns
    ``{"left": ContactList, "right": ContactList}`` with reference-exact
    overlap semantics (touching windows are rejected, so stance windows are
    kept strictly separated by the swing gap).
    """
    left = ContactList(default_name="left")
    right = ContactList(default_name="right")
    x0, y0 = start_position
    yl, yr = y0 + step_width / 2, y0 - step_width / 2

    first_stance_end = step_duration
    pos = {"left": np.array([x0, yl, 0.0]), "right": np.array([x0, yr, 0.0])}
    swing_order = ["left", "right"] * ((num_steps + 1) // 2)
    lists = {"left": left, "right": right}

    # each foot's stance windows: a foot stays in stance until it swings,
    # then lands step_length further ahead.
    stance_start = {"left": 0.0, "right": 0.0}
    for k, foot in enumerate(swing_order[:num_steps]):
        swing_start = first_stance_end + k * step_duration
        swing_end = swing_start + step_duration - double_support
        if not lists[foot].add_contact(
                position=pos[foot].copy(), activation_time=stance_start[foot],
                deactivation_time=swing_start):
            raise ValueError(f"step {k}: the {foot} stance window is rejected")
        pos[foot] = pos[foot] + np.array([step_length, 0.0, 0.0])
        stance_start[foot] = swing_end
    total = first_stance_end + num_steps * step_duration + step_duration
    for foot in ("left", "right"):
        if not lists[foot].add_contact(
                position=pos[foot].copy(), activation_time=stance_start[foot],
                deactivation_time=total):
            raise ValueError(f"the final {foot} stance window is rejected")
    return lists


def gait_horizon(lists: dict, dt: float) -> int:
    """Knots of a gait: its last deactivation over ``dt``, rounded."""
    total_time = max(lst.last_contact().deactivation_time for lst in lists.values())
    return int(round(total_time / dt))


_FOOT_CORNERS = np.array([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0], [-1.0, -1.0]])


def support_polygons(
    schedule: ContactScheduleArrays,
    half_length: float = 0.07,
    half_width: float = 0.04,
    max_halfspaces: int = 8,
    *,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-knot ZMP support polygons as padded half-spaces.

    For each knot, the corner points of every *active* foot (E feet x 4
    corners, with a validity mask) go through the batched monotone chain ->
    padded ``A x <= b`` rows (inactive rows are the always-true constraint).
    If NO foot is active at a knot (flight; :func:`footstep_plan` makes
    none), the previous knot's polygon is reused.

    Returns ``(poly_A (T, F, 2), poly_b (T, F))`` with ``F = max_halfspaces``,
    on ``device`` in ``dtype`` (the GPU and float32 by default).
    """
    device, dtype = resolve_device(device), resolve_dtype(dtype)
    E, T = schedule.active.shape
    corners = _FOOT_CORNERS * np.array([half_length, half_width])
    # world corner points per (knot, foot, corner)
    foot_xy = np.transpose(schedule.position[:, :, :2], (1, 0, 2))  # (T, E, 2)
    # rotate corners by the foothold yaw (rotation's top-left 2x2)
    rot2 = np.transpose(schedule.rotation[:, :, :2, :2], (1, 0, 2, 3))
    pts = foot_xy[:, :, None, :] + np.einsum("teij,cj->teci", rot2, corners)  # (T, E, 4, 2)
    valid = np.repeat(np.transpose(schedule.active, (1, 0))[:, :, None], 4, axis=2)
    with trace("sync.h2d"):
        pts = torch.as_tensor(pts.reshape(T, E * 4, 2), dtype=dtype, device=device)
    with trace("sync.h2d"):
        valid = torch.as_tensor(valid.reshape(T, E * 4), device=device)

    A, b = halfspaces_from_polygon(monotone_chain_2d(pts, valid))
    F = A.shape[1]
    if F < max_halfspaces:
        pad = max_halfspaces - F
        A = torch.nn.functional.pad(A, (0, 0, 0, pad))
        b = torch.nn.functional.pad(b, (0, pad), value=1.0)
    else:
        A, b = A[:, :max_halfspaces], b[:, :max_halfspaces]
    A, b = A.contiguous(), b.contiguous()

    # flight knots: carry the previous polygon forward (host-side fix-up)
    any_active = schedule.active.any(axis=0)
    for k in range(1, T):
        if not any_active[k]:
            A[k], b[k] = A[k - 1], b[k - 1]
    return A, b


def gait_references(params: LIPMParams, schedule: ContactScheduleArrays, dt):
    """ZMP reference = centroid of the active feet per knot; DCM reference by
    the backward recursion ending on the final stance centroid. Tensors on
    the device and in the dtype of ``params``."""
    active = schedule.active.astype(np.float64)            # (E, T)
    weights = active / np.maximum(active.sum(axis=0, keepdims=True), 1.0)
    zmp_ref = np.einsum("et,eta->ta", weights, schedule.position[:, :, :2])
    # knots with no active foot: hold previous
    any_active = schedule.active.any(axis=0)
    for k in range(1, len(any_active)):
        if not any_active[k]:
            zmp_ref[k] = zmp_ref[k - 1]
    like = params.com_height
    with trace("sync.h2d"):
        zmp_ref = torch.as_tensor(zmp_ref, dtype=like.dtype, device=like.device)
    dcm_ref = dcm_backward_recursion(params, zmp_ref, zmp_ref[-1], dt)
    return zmp_ref, dcm_ref


def plan_gait(
    params: LIPMParams,
    lists: dict,
    dt: float,
    dcm0,
    com0,
    *,
    half_length: float = 0.07,
    half_width: float = 0.04,
    weights: Optional[DCMWeights] = None,
    iterations: int = 1000,
    horizon: Optional[int] = None,
    **qp_kwargs,
) -> Tuple[DCMPlan, ContactScheduleArrays]:
    """Full-gait DCM plan (config 3): schedule -> hulls -> refs -> QP.

    ``dcm0``/``com0`` may carry a batch (one plan a lane, all on the same
    gait); they are cast to the working dtype of ``params``. ``qp_kwargs``
    go to :func:`blf_tpu_torch.mpc.dcm.solve_dcm_mpc`: ``shared=True`` with
    ``backend="cuda"`` solves a batch against one factorization on the
    kernels.
    """
    with trace("gait.plan"):
        with trace("gait.schedule"):
            T = horizon if horizon is not None else gait_horizon(lists, dt)
            schedule = lower_contact_schedule(lists, dt=dt, horizon=T)
        like = params.com_height
        with trace("gait.hulls"):
            poly_A, poly_b = support_polygons(schedule, half_length, half_width,
                                              device=like.device, dtype=like.dtype)
        with trace("gait.references"):
            zmp_ref, dcm_ref = gait_references(params, schedule, dt)
        as_work = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)
        plan = solve_dcm_mpc(params, dt, as_work(dcm0), as_work(com0), dcm_ref, zmp_ref,
                             poly_A, poly_b, weights, iterations=iterations, **qp_kwargs)
    return plan, schedule
