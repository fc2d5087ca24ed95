"""Fused rigid-foot contact rollout: CUDA kernel wrapper and plain version.

Counterpart of ``blf_tpu/ops/pallas/rollout.py``; everything of it is
ported. K5, ``foot_rollout_fused`` (the reference's ``_rollout_kernel``):
``steps`` forward-Euler steps of a rigid foot on the spring-damper patch,
per lane, in one launch (``csrc/foot_rollout.cu``). Each step computes the
closed-form patch wrench, Newton-Euler with diagonal body inertia, and the
Baumgarte SO(3) rate with the adjugate inverse of ``S = R R'``; the math is
:func:`blf_tpu_torch.models.foot.foot_dynamics` written out component by
component, in the reference kernel's order.

Layout is lane-major at the boundary and in device memory: position (B, 3),
rotation (B, 3, 3), velocities (B, 3); the null pose (B, 3) / (B, 3, 3) or
one pose for every lane ((3,) / (3, 3), or a (B, ...) view whose lane stride
is 0); ``spring_coeff`` and ``damper_coeff`` scalar, (B,) or (B, 1). The
eight scalars (L, W, mass, I1..3, rho, dt) go to the kernel as one device
tensor, made without reading anything back to the host. The reference's
struct-of-tiles layout, its padding of odd batches, ``block_lanes``,
``chunks``, ``step_unroll`` and ``interpret`` are TPU matters and have no
counterpart here: the kernel checks each lane against ``B``.

- :func:`foot_rollout_fused_reference` is the plain PyTorch version: the
  kernel's arithmetic on (B,) tensors, any float dtype.
- :func:`foot_rollout_fused` runs the plain version for tensors that lie on
  the CPU and launches the hand-written kernel for CUDA tensors. There it
  launches or raises: nothing falls back. :func:`launch_count` and
  :func:`reference_count` count each.
"""

from __future__ import annotations

import ctypes

import torch

from blf_tpu_torch.ops.cuda import _build

__all__ = ["foot_rollout_fused", "foot_rollout_fused_reference", "launch_count",
           "reference_count", "reset_counts", "build_foot_rollout", "rollout_operands",
           "GRAVITY_Z", "SOURCE", "REPLACES"]

SOURCE = "foot_rollout.cu"
#: the TPU kernel K5 replaces (file:line of ``_rollout_kernel``)
REPLACES = "blf_tpu/ops/pallas/rollout.py:66"
GRAVITY_Z = -9.81

# Plain integers: how often the kernel was launched, and how often its plain
# version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0}
_libs: dict = {}


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_counts`."""
    return _counts["launch"]


def reference_count() -> int:
    """Plain-version runs made by :func:`foot_rollout_fused` for CPU tensors."""
    return _counts["reference"]


def reset_counts() -> None:
    for key in _counts:
        _counts[key] = 0


def _lane_operand(t: torch.Tensor, tail: tuple, B: int, name: str):
    """``(tensor, per_lane)``: a per-lane ``(B, *tail)`` operand, or one value
    for every lane (``tail``-shaped, or a ``(B, *tail)`` view with lane stride
    0), which the kernel reads with lane stride 0."""
    if tuple(t.shape) == tail:
        return t, False
    if tuple(t.shape) != (B,) + tail:
        raise ValueError(f"{name} must be {tail} or {(B,) + tail}, got {tuple(t.shape)}")
    if B > 1 and t.stride(0) == 0:
        return t[0], False
    return t, True


def _coefficient(c, B: int, like: torch.Tensor, name: str):
    """A contact coefficient as ``(tensor, per_lane)``: scalar, (B,) or (B, 1)."""
    c = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    if c.numel() == 1:
        return c.reshape(()), False
    if tuple(c.shape) not in ((B,), (B, 1)):
        raise ValueError(f"{name} must be a scalar, ({B},) or ({B}, 1), got {tuple(c.shape)}")
    return c.reshape(B), True


def rollout_operands(cparams, fparams, state, null_position, null_rotation, dt):
    """What the kernel reads, checked: ``(p, R, v, w, p0, R0, k, b, scalars,
    per_lane)`` with ``per_lane`` the flags of ``p0, R0, k, b``, ``scalars``
    the (8,) tensor ``(L, W, mass, I1, I2, I3, rho, dt)`` on the state's
    device and in its dtype."""
    p = state.position
    if p.dim() != 2 or p.shape[-1] != 3 or p.shape[0] < 1:
        raise ValueError(f"position must be (B, 3) with B >= 1, got {tuple(p.shape)}")
    B = p.shape[0]
    shapes = {"rotation": (B, 3, 3), "linear_velocity": (B, 3), "angular_velocity": (B, 3)}
    for name, shape in shapes.items():
        if tuple(getattr(state, name).shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(getattr(state, name).shape)}")
    p0, p0_lanes = _lane_operand(null_position, (3,), B, "null_position")
    R0, R0_lanes = _lane_operand(null_rotation, (3, 3), B, "null_rotation")
    k, k_lanes = _coefficient(cparams.spring_coeff, B, p, "spring_coeff")
    b, b_lanes = _coefficient(cparams.damper_coeff, B, p, "damper_coeff")
    as_t = lambda x: torch.as_tensor(x, dtype=p.dtype, device=p.device).reshape(-1)
    scalars = torch.cat([as_t(x) for x in (cparams.length, cparams.width, fparams.mass,
                                           fparams.inertia, fparams.baumgarte_rho, dt)])
    if scalars.shape != (8,):
        raise ValueError("length, width, mass, baumgarte_rho and dt must be scalars and"
                         f" inertia (3,); got {scalars.shape[0]} values in all")
    return (p, state.rotation, state.linear_velocity, state.angular_velocity, p0, R0,
            k, b, scalars, (p0_lanes, R0_lanes, k_lanes, b_lanes))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _mat_vec(r, v):
    """``r``: 9 entries, row-major ``R[i][j] = r[3i + j]``; ``v``: 3."""
    return tuple(r[3 * i] * v[0] + r[3 * i + 1] * v[1] + r[3 * i + 2] * v[2]
                 for i in range(3))


def _mat_t_vec(r, v):
    return tuple(r[j] * v[0] + r[3 + j] * v[1] + r[6 + j] * v[2] for j in range(3))


def _euler_step(p, r, v, w, p0, r0e1, r0e2, k, b, consts):
    """One step of the kernel, component by component; every entry a (B,)
    tensor (or one that broadcasts to it)."""
    area, L2, W2, mass, I1, I2, I3, half_rho, dt = consts
    # the closed-form patch wrench
    ar33 = r[8].abs()
    fscale = ar33 * area
    f = tuple(fscale * (k * (p0[i] - p[i]) - b * v[i]) for i in range(3))
    re1 = (r[0], r[3], r[6])
    re2 = (r[1], r[4], r[7])
    e1w = _cross(re1, _cross(re1, w))
    e2w = _cross(re2, _cross(re2, w))
    e1r0 = _cross(re1, r0e1)
    e2r0 = _cross(re2, r0e2)
    tscale = ar33 * (area / 12.0)
    tau = tuple(tscale * (L2 * (b * e1w[i] + k * e1r0[i]) + W2 * (b * e2w[i] + k * e2r0[i]))
                for i in range(3))
    # Newton-Euler with diagonal body inertia
    v_dot = (f[0] / mass, f[1] / mass, f[2] / mass + GRAVITY_Z)
    u = _mat_t_vec(r, w)
    iww = _mat_vec(r, (I1 * u[0], I2 * u[1], I3 * u[2]))
    gyro = _cross(w, iww)
    te = tuple(tau[i] - gyro[i] for i in range(3))
    ut = _mat_t_vec(r, te)
    w_dot = _mat_vec(r, (ut[0] / I1, ut[1] / I2, ut[2] / I3))
    # Rdot = w^ R + rho/2 (S^-1 - I) R, S = R R' (adjugate inverse)
    s00 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
    s01 = r[0] * r[3] + r[1] * r[4] + r[2] * r[5]
    s02 = r[0] * r[6] + r[1] * r[7] + r[2] * r[8]
    s11 = r[3] * r[3] + r[4] * r[4] + r[5] * r[5]
    s12 = r[3] * r[6] + r[4] * r[7] + r[5] * r[8]
    s22 = r[6] * r[6] + r[7] * r[7] + r[8] * r[8]
    c00 = s11 * s22 - s12 * s12
    c01 = s02 * s12 - s01 * s22
    c02 = s01 * s12 - s02 * s11
    c11 = s00 * s22 - s02 * s02
    c12 = s01 * s02 - s00 * s12
    c22 = s00 * s11 - s01 * s01
    det = s00 * c00 + s01 * c01 + s02 * c02
    inv = 1.0 / det
    m_rows = ((c00 * inv - 1.0, c01 * inv, c02 * inv),
              (c01 * inv, c11 * inv - 1.0, c12 * inv),
              (c02 * inv, c12 * inv, c22 * inv - 1.0))
    r_dot = []
    for i in range(3):
        for j in range(3):
            col = (r[j], r[3 + j], r[6 + j])
            wxr = w[(i + 1) % 3] * col[(i + 2) % 3] - w[(i + 2) % 3] * col[(i + 1) % 3]
            corr = m_rows[i][0] * r[j] + m_rows[i][1] * r[3 + j] + m_rows[i][2] * r[6 + j]
            r_dot.append(wxr + half_rho * corr)
    # forward Euler, x += dt f(x)
    return (tuple(p[i] + dt * v[i] for i in range(3)),
            tuple(r[i] + dt * r_dot[i] for i in range(9)),
            tuple(v[i] + dt * v_dot[i] for i in range(3)),
            tuple(w[i] + dt * w_dot[i] for i in range(3)))


def foot_rollout_fused_reference(cparams, fparams, state, null_position, null_rotation,
                                 *, dt, steps: int):
    """Plain PyTorch version (any float dtype, any device): the kernel's
    arithmetic, component by component on (B,) tensors, ``steps`` times.
    Returns the final state, of the input's type and shapes."""
    p, R, v, w, p0, R0, k, b, scal, _ = rollout_operands(
        cparams, fparams, state, null_position, null_rotation, dt)
    L, W, mass, I1, I2, I3, rho, dt_ = scal.unbind()
    area = L * W
    consts = (area, L * L, W * W, mass, I1, I2, I3, 0.5 * rho, dt_)
    cols = lambda t: tuple(t[..., i] for i in range(t.shape[-1]))
    R0f = R0.reshape(R0.shape[:-2] + (9,))
    p0c, r0 = cols(p0), cols(R0f)
    r0e1, r0e2 = (r0[0], r0[3], r0[6]), (r0[1], r0[4], r0[7])
    x = (cols(p), cols(R.reshape(-1, 9)), cols(v), cols(w))
    for _ in range(int(steps)):
        x = _euler_step(*x, p0c, r0e1, r0e2, k, b, consts)
    pn, rn, vn, wn = (torch.stack(c, dim=-1) for c in x)
    return type(state)(pn, rn.reshape(-1, 3, 3), vn, wn)


def build_foot_rollout() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = _libs.get(SOURCE)
    if lib is not None:
        return lib
    lib = _build.load_library(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.blf_foot_rollout_f32.argtypes = [P] * 13 + [ctypes.c_longlong, I, I, I, I, I, P]
    lib.blf_foot_rollout_f32.restype = I
    lib.blf_cuda_error_string.argtypes = [I]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    _libs[SOURCE] = lib
    return lib


def foot_rollout_fused(cparams, fparams, state, null_position, null_rotation, *, dt,
                       steps: int):
    """Run ``steps`` Euler steps of every lane; returns the final state, of
    the input's type and shapes (see the module doc for what each operand
    may be).

    CPU tensors go through :func:`foot_rollout_fused_reference`. CUDA tensors
    must be float32, all on one device; the kernel is launched on the current
    stream, its launch error is checked, and the call does not synchronise.
    """
    if state.position.device.type == "cpu":
        _counts["reference"] += 1
        return foot_rollout_fused_reference(cparams, fparams, state, null_position,
                                            null_rotation, dt=dt, steps=steps)
    device = state.position.device
    if device.type != "cuda":
        raise ValueError(f"foot_rollout_fused runs on cpu or cuda tensors, not {device}")
    steps = int(steps)
    if steps < 0 or steps > 2**31 - 1:
        raise ValueError(f"steps must be in [0, 2^31), got {steps}")
    p, R, v, w, p0, R0, k, b, scal, per_lane = rollout_operands(
        cparams, fparams, state, null_position, null_rotation, dt)
    operands = (p, R, v, w, p0, R0, k, b)
    for t in operands:
        if t.device != device or t.dtype != torch.float32:
            raise TypeError(f"foot_rollout_fused kernel takes float32 tensors on {device};"
                            f" got {t.dtype} on {t.device}")
    p, R, v, w, p0, R0, k, b = (t.contiguous() for t in operands)
    B = p.shape[0]
    lib = build_foot_rollout()
    out = [torch.empty_like(t) for t in (p, R, v, w)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.blf_foot_rollout_f32(
            *(t.data_ptr() for t in (p, R, v, w, p0, R0, k, b, scal, *out)),
            B, steps, *(int(flag) for flag in per_lane), stream)
    if code != 0:
        what = (lib.blf_cuda_error_string(code).decode() if code > 0
                else {-2: "bad batch"}.get(code, "?"))
        raise RuntimeError(f"foot_rollout_fused launch failed ({code}): {what}")
    _counts["launch"] += 1
    return type(state)(*out)
