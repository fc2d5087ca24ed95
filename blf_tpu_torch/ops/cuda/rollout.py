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
eight scalars (L, W, mass, I1..3, rho, dt) go to the kernel by value, a
:class:`FootScalars` argument, as do k and b where they are scalars: a launch
copies nothing to the device and allocates one buffer, the outputs'. What
the kernel takes of the parameters and the null pose is made once for each
set of those objects (cached by their identity and their tensors' in-place
versions), so a device tensor among them costs one synchronising read, not
one a launch. The reference's
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
           "launch_operands", "FootScalars", "GRAVITY_Z", "SOURCE", "REPLACES"]

SOURCE = "foot_rollout.cu"
#: the TPU kernel K5 replaces (file:line of ``_rollout_kernel``)
REPLACES = "blf_tpu/ops/pallas/rollout.py:66"
GRAVITY_Z = -9.81

# Plain integers: how often the kernel was launched, and how often its plain
# version ran because the tensors lie on the CPU.
_counts = {"launch": 0, "reference": 0}
_libs: dict = {}


class FootScalars(ctypes.Structure):
    """The rollout's scalars as the kernel takes them, by value
    (``csrc/foot_rollout.cu``), in the order of :func:`rollout_operands`'
    (8,) tensor."""

    _fields_ = [("length", ctypes.c_float), ("width", ctypes.c_float),
                ("mass", ctypes.c_float), ("inertia", ctypes.c_float * 3),
                ("baumgarte_rho", ctypes.c_float), ("dt", ctypes.c_float)]


# What the kernel takes of a rollout's parameters and null pose, keyed by the
# identity of the objects passed: (objects, their tensors, the tensors'
# in-place versions, operands). The entry holds the objects, so no id is
# reused while it is cached; an in-place change of any of their tensors
# changes its version, and the entry is made anew.
_param_cache: dict = {}
_PARAM_CACHE_SIZE = 16


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


def _batch_of(state) -> int:
    """The batch, checked against every state field."""
    p = state.position
    if p.dim() != 2 or p.shape[-1] != 3 or p.shape[0] < 1:
        raise ValueError(f"position must be (B, 3) with B >= 1, got {tuple(p.shape)}")
    B = p.shape[0]
    for name, shape in (("rotation", (B, 3, 3)), ("linear_velocity", (B, 3)),
                        ("angular_velocity", (B, 3))):
        if getattr(state, name).shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(getattr(state, name).shape)}")
    return B


def _scalars_error(count: int) -> ValueError:
    return ValueError("length, width, mass, baumgarte_rho and dt must be scalars and"
                      f" inertia (3,); got {count} values in all")


def rollout_operands(cparams, fparams, state, null_position, null_rotation, dt):
    """What the plain version reads, checked: ``(p, R, v, w, p0, R0, k, b,
    scalars, per_lane)`` with ``per_lane`` the flags of ``p0, R0, k, b``,
    ``scalars`` the (8,) tensor ``(L, W, mass, I1, I2, I3, rho, dt)`` on the
    state's device and in its dtype."""
    p = state.position
    B = _batch_of(state)
    p0, p0_lanes = _lane_operand(null_position, (3,), B, "null_position")
    R0, R0_lanes = _lane_operand(null_rotation, (3, 3), B, "null_rotation")
    k, k_lanes = _coefficient(cparams.spring_coeff, B, p, "spring_coeff")
    b, b_lanes = _coefficient(cparams.damper_coeff, B, p, "damper_coeff")
    as_t = lambda x: torch.as_tensor(x, dtype=p.dtype, device=p.device).reshape(-1)
    scalars = torch.cat([as_t(x) for x in (cparams.length, cparams.width, fparams.mass,
                                           fparams.inertia, fparams.baumgarte_rho, dt)])
    if scalars.shape != (8,):
        raise _scalars_error(scalars.shape[0])
    return (p, state.rotation, state.linear_velocity, state.angular_velocity, p0, R0,
            k, b, scalars, (p0_lanes, R0_lanes, k_lanes, b_lanes))


def _host_values(x) -> list:
    """The values of a number, a sequence of numbers or a tensor as Python
    floats (a device tensor is read back: the caller caches the result)."""
    if torch.is_tensor(x):
        return x.detach().reshape(-1).tolist()
    return [float(v) for v in (x if isinstance(x, (list, tuple)) else [x])]


def _kernel_coefficient(c, B: int, name: str):
    """A contact coefficient as the kernel takes it: ``(tensor, None)`` per
    lane ((B,) or (B, 1)), or ``(None, value)`` for one value for all lanes
    (a number, a one-element tensor, or a per-lane view with lane stride 0)."""
    if not torch.is_tensor(c) or c.numel() == 1:
        values = _host_values(c)
        if len(values) != 1:
            raise ValueError(f"{name} must be a scalar, ({B},) or ({B}, 1)")
        return None, values[0]
    if tuple(c.shape) not in ((B,), (B, 1)):
        raise ValueError(f"{name} must be a scalar, ({B},) or ({B}, 1), got {tuple(c.shape)}")
    c = c.reshape(B)
    if c.stride(0) == 0:
        return None, _host_values(c[:1])[0]
    return c.contiguous(), None


def _tensors_in(objects) -> list:
    found = []
    for x in objects:
        if torch.is_tensor(x):
            found.append(x)
        elif isinstance(x, tuple):
            found.extend(_tensors_in(x))
    return found


def _param_operands(cparams, fparams, null_position, null_rotation, dt, B: int):
    """``(p0, R0, k, b, scalars, k_value, b_value, per_lane)``: what the kernel
    takes of the parameters and the null pose, made once for each set of
    objects and kept while none of their tensors changes in place."""
    objects = (cparams, fparams, null_position, null_rotation, dt)
    key = tuple(id(x) for x in objects) + (B,)
    hit = _param_cache.get(key)
    if hit is not None and tuple(t._version for t in hit[1]) == hit[2]:
        return hit[3]
    p0, p0_lanes = _lane_operand(null_position, (3,), B, "null_position")
    R0, R0_lanes = _lane_operand(null_rotation, (3, 3), B, "null_rotation")
    k, k_value = _kernel_coefficient(cparams.spring_coeff, B, "spring_coeff")
    b, b_value = _kernel_coefficient(cparams.damper_coeff, B, "damper_coeff")
    values = [_host_values(x) for x in (cparams.length, cparams.width, fparams.mass,
                                        fparams.inertia, fparams.baumgarte_rho, dt)]
    if [len(v) for v in values] != [1, 1, 1, 3, 1, 1]:
        raise _scalars_error(sum(len(v) for v in values))
    (length,), (width,), (mass,), inertia, (rho,), (step,) = values
    operands = (p0.contiguous(), R0.contiguous(), k, b,
                FootScalars(length, width, mass, (ctypes.c_float * 3)(*inertia), rho, step),
                0.0 if k is not None else k_value, 0.0 if b is not None else b_value,
                (p0_lanes, R0_lanes, k is not None, b is not None))
    tensors = _tensors_in(objects)
    if not any(t.is_inference() for t in tensors):     # those keep no version
        if len(_param_cache) >= _PARAM_CACHE_SIZE:
            _param_cache.clear()
        _param_cache[key] = (objects, tensors, tuple(t._version for t in tensors), operands)
    return operands


def launch_operands(cparams, fparams, state, null_position, null_rotation, dt):
    """What the kernel takes, checked: ``(tensors, scalars, k_value,
    b_value, per_lane)`` with ``tensors`` the contiguous ``(p, R, v, w, p0,
    R0, k, b)`` (``k``/``b`` None where one value serves every lane, then
    ``k_value``/``b_value``), ``scalars`` a :class:`FootScalars` of the
    parameters' host values and ``per_lane`` the flags of ``p0, R0, k, b``.
    Nothing is copied to the device; a device tensor among the parameters
    is read back once for each set of parameter objects, not at every call."""
    B = _batch_of(state)
    p0, R0, k, b, scalars, k_value, b_value, per_lane = _param_operands(
        cparams, fparams, null_position, null_rotation, dt, B)
    return ((*(t if t.is_contiguous() else t.contiguous() for t in state), p0, R0, k, b),
            scalars, k_value, b_value, per_lane)


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
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.blf_foot_rollout_f32.argtypes = [P] * 8 + [FootScalars, F, F, P, ctypes.c_longlong,
                                                   I, I, I, I, I, P]
    lib.blf_foot_rollout_f32.restype = I
    lib.blf_cuda_error_string.argtypes = [I]
    lib.blf_cuda_error_string.restype = ctypes.c_char_p
    lib.blf_foot_scalars_bytes.argtypes = []
    lib.blf_foot_scalars_bytes.restype = I
    if lib.blf_foot_scalars_bytes() != ctypes.sizeof(FootScalars):
        raise RuntimeError("foot_rollout library disagrees with its wrapper on FootScalars")
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
    The four output fields are views of one buffer.
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
    tensors, scalars, k_value, b_value, per_lane = launch_operands(
        cparams, fparams, state, null_position, null_rotation, dt)
    ptrs = []
    for t in tensors:
        if t is None:
            ptrs.append(None)
            continue
        if t.device != device or t.dtype is not torch.float32:
            raise TypeError(f"foot_rollout_fused kernel takes float32 tensors on {device};"
                            f" got {t.dtype} on {t.device}")
        ptrs.append(t.data_ptr())
    B = tensors[0].shape[0]
    lib = build_foot_rollout()
    out = torch.empty(18 * B, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.blf_foot_rollout_f32(
            *ptrs, scalars, k_value, b_value, out.data_ptr(), B, steps, *per_lane,
            torch.cuda.current_stream().cuda_stream)
    if code != 0:
        what = (lib.blf_cuda_error_string(code).decode() if code > 0
                else {-2: "bad batch"}.get(code, "?"))
        raise RuntimeError(f"foot_rollout_fused launch failed ({code}): {what}")
    _counts["launch"] += 1
    return type(state)(out.as_strided((B, 3), (3, 1)),
                       out.as_strided((B, 3, 3), (9, 3, 1), 3 * B),
                       out.as_strided((B, 3), (3, 1), 12 * B),
                       out.as_strided((B, 3), (3, 1), 15 * B))
