"""SO(3)/SE(3) utilities as pure, batch-explicit tensor functions.

Counterpart of ``blf_tpu/ops/lie.py``; everything of it is ported. Rotations
are plain ``(..., 3, 3)`` tensors, positions ``(..., 3)`` tensors and twists
``(..., 6)`` tensors in **mixed representation** (linear part in the world
frame at the frame origin, angular part in the world frame).

Every function broadcasts over leading batch axes, writes nothing in place
and never leaves the device, so ``torch.func.jvp`` passes through it. The
small-angle branches are written with a double ``where`` so that the branch
not taken stays finite under differentiation (a ``jvp`` through
:func:`so3_exp` at angle 0 is finite).
"""

from __future__ import annotations

import torch

__all__ = [
    "skew",
    "unskew",
    "so3_exp",
    "so3_log",
    "so3_baumgarte_rate",
    "rotation_rate_mixed",
    "quat_to_rot",
    "rot_to_quat",
    "se3_compose",
    "se3_apply",
    "se3_inverse",
    "rpy_to_rot",
]


def skew(v: torch.Tensor) -> torch.Tensor:
    """``(..., 3) -> (..., 3, 3)`` skew-symmetric map, ``skew(v) @ u = v x u``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`skew` (the antisymmetric part is used)."""
    return torch.stack(
        [
            0.5 * (m[..., 2, 1] - m[..., 1, 2]),
            0.5 * (m[..., 0, 2] - m[..., 2, 0]),
            0.5 * (m[..., 1, 0] - m[..., 0, 1]),
        ],
        dim=-1,
    )


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: ``(..., 3)`` rotation vector -> ``(..., 3, 3)``.

    Taylor-guarded at angle 0 so it is differentiable there and stable in
    float32.
    """
    theta2 = (omega * omega).sum(dim=-1)
    # sin t / t and (1 - cos t) / t^2 with series near zero; the branch not
    # taken must stay NaN-free under differentiation (double where)
    small = theta2 < 1e-12
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    k = skew(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> rotation vector (principal branch, angle in [0, pi))."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = unskew(rot)
    sin_theta = torch.sin(theta)
    small = theta < 1e-6
    scale = torch.where(
        small, 1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), sin_theta))
    return scale[..., None] * w


def rotation_rate_mixed(rot: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """``Rdot = skew(omega) R`` for a world-frame angular velocity."""
    return skew(omega) @ rot


def so3_baumgarte_rate(rot: torch.Tensor, omega: torch.Tensor, rho) -> torch.Tensor:
    """Rotation-matrix rate with Baumgarte orthonormality stabilisation:
    ``Rdot = skew(omega) R + rho/2 ((R R')^-1 - I) R``, which drives
    ``R R' -> I`` under the drift of a matrix-valued integrator."""
    rrt = rot @ rot.transpose(-1, -2)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    correction = (torch.linalg.inv(rrt) - eye) @ rot
    return rotation_rate_mixed(rot, omega) + 0.5 * rho * correction


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``(..., 4)`` (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0.

    Branchless Shepperd-style construction (max-component select).
    """
    m = rot
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    def scale(t):
        return torch.sqrt(torch.clamp(t, min=1e-12)) * 2.0

    s0, s1, s2, s3 = scale(t0), scale(t1), scale(t2), scale(t3)
    cand0 = torch.stack(
        [0.25 * s0,
         (m[..., 2, 1] - m[..., 1, 2]) / s0,
         (m[..., 0, 2] - m[..., 2, 0]) / s0,
         (m[..., 1, 0] - m[..., 0, 1]) / s0], -1)
    cand1 = torch.stack(
        [(m[..., 2, 1] - m[..., 1, 2]) / s1,
         0.25 * s1,
         (m[..., 0, 1] + m[..., 1, 0]) / s1,
         (m[..., 0, 2] + m[..., 2, 0]) / s1], -1)
    cand2 = torch.stack(
        [(m[..., 0, 2] - m[..., 2, 0]) / s2,
         (m[..., 0, 1] + m[..., 1, 0]) / s2,
         0.25 * s2,
         (m[..., 1, 2] + m[..., 2, 1]) / s2], -1)
    cand3 = torch.stack(
        [(m[..., 1, 0] - m[..., 0, 1]) / s3,
         (m[..., 0, 2] + m[..., 2, 0]) / s3,
         (m[..., 1, 2] + m[..., 2, 1]) / s3,
         0.25 * s3], -1)

    cands = torch.stack([cand0, cand1, cand2, cand3], dim=-2)
    traces = torch.stack([t0, t1, t2, t3], dim=-1)
    idx = torch.argmax(traces, dim=-1)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rpy_to_rot(roll, pitch, yaw) -> torch.Tensor:
    """ZYX roll-pitch-yaw -> rotation, ``R = Rz(yaw) Ry(pitch) Rx(roll)``.

    Plain numbers are taken as float32 tensors on the CPU; tensors keep their
    dtype and device.
    """
    roll, pitch, yaw = (torch.as_tensor(a) for a in (roll, pitch, yaw))
    if not roll.is_floating_point():
        roll, pitch, yaw = roll.float(), pitch.float(), yaw.float()
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            torch.stack([-sp, cp * sr, cp * cr], -1),
        ],
        dim=-2,
    )


# -- SE(3) as (rotation, position) pairs ------------------------------------

def se3_compose(rot_ab, pos_ab, rot_bc, pos_bc):
    """``T_ac = T_ab o T_bc`` for (R, p) pairs."""
    return rot_ab @ rot_bc, pos_ab + torch.einsum("...ij,...j->...i", rot_ab, pos_bc)


def se3_apply(rot, pos, point):
    """Apply the transform to a ``(..., 3)`` point."""
    return torch.einsum("...ij,...j->...i", rot, point) + pos


def se3_inverse(rot, pos):
    rt = rot.transpose(-1, -2)
    return rt, -torch.einsum("...ij,...j->...i", rt, pos)
