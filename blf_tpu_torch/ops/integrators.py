"""Fixed-step ODE integrators over nested-tuple states.

Counterpart of ``blf_tpu/ops/integrators.py``. Ported: ``forward_euler_step``,
``midpoint_step``, ``rk4_step``, ``STEP_FUNCTIONS`` and ``integrate``. Not yet
ported: ``integrate_rosenbrock`` and ``rosenbrock_operator`` (the stiff
ROS2-W integrator; they raise ``NotImplementedError``, ROADMAP.md slice 2b).

A dynamics function is a pure function ``f(state, input, t) -> dstate`` where
``state`` and ``dstate`` are trees of tensors of one structure: a tensor, or
a (named) tuple, list or dict of such trees. The reference's ``lax.scan``
over steps is a Python loop here; every step is a handful of tensor ops over
whatever leading batch axes the leaves carry.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = [
    "forward_euler_step",
    "midpoint_step",
    "rk4_step",
    "STEP_FUNCTIONS",
    "integrate",
    "integrate_rosenbrock",
    "rosenbrock_operator",
]

DynamicsFn = Callable[[Any, Any, Any], Any]


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of trees of one structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):       # NamedTuple
        return type(tree)(*(_tree_map(fn, *parts) for parts in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, *parts) for parts in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    raise TypeError(f"unsupported state node {type(tree).__name__}")


def _axpy(x, dx, a):
    """``x + a dx`` leaf-wise."""
    return _tree_map(lambda xi, di: xi + a * di, x, dx)


def forward_euler_step(f: DynamicsFn, x, u, t, dt):
    """Explicit Euler ``x <- x + dt f(x, u, t)``."""
    return _axpy(x, f(x, u, t), dt)


def midpoint_step(f: DynamicsFn, x, u, t, dt):
    """Explicit midpoint (RK2); input held zero-order."""
    k1 = f(x, u, t)
    k2 = f(_axpy(x, k1, dt / 2), u, t + dt / 2)
    return _axpy(x, k2, dt)


def rk4_step(f: DynamicsFn, x, u, t, dt):
    """Classic RK4; input held zero-order across substeps."""
    k1 = f(x, u, t)
    k2 = f(_axpy(x, k1, dt / 2), u, t + dt / 2)
    k3 = f(_axpy(x, k2, dt / 2), u, t + dt / 2)
    k4 = f(_axpy(x, k3, dt), u, t + dt)
    ksum = _tree_map(lambda a, b, c, d: a + 2 * b + 2 * c + d, k1, k2, k3, k4)
    return _axpy(x, ksum, dt / 6)


STEP_FUNCTIONS = {
    "euler": forward_euler_step,
    "midpoint": midpoint_step,
    "rk4": rk4_step,
}


def integrate(
    f: DynamicsFn,
    x0,
    *,
    dt: float,
    num_steps: int,
    us=None,
    u=None,
    t0: float = 0.0,
    method: str = "euler",
    save_trajectory: bool = False,
):
    """Integrate ``xdot = f(x, u, t)`` for ``num_steps`` fixed steps of ``dt``.

    Args:
      f: pure dynamics ``f(state, input, t) -> dstate`` over matching trees.
      x0: initial state tree.
      dt: step size, a plain number.
      num_steps: step count.
      us: optional time-varying input tree whose leaves carry a leading
        ``num_steps`` axis (one input per step).
      u: optional constant input (zero-order hold); mutually exclusive with
        ``us``.
      t0: initial time; ``f`` sees the plain number ``t0 + k dt``.
      method: one of ``STEP_FUNCTIONS``.
      save_trajectory: if True also return the state trajectory including
        ``x0`` (leaves get a leading ``num_steps + 1`` axis).

    Returns:
      ``x_final`` or ``(x_final, trajectory)``.
    """
    if method not in STEP_FUNCTIONS:
        raise ValueError(f"unknown method {method!r}; pick from {sorted(STEP_FUNCTIONS)}")
    if us is not None and u is not None:
        raise ValueError("pass either `us` (per-step) or `u` (constant), not both")
    step = STEP_FUNCTIONS[method]
    x = x0
    states = [x0]
    for k in range(num_steps):
        u_eff = u if us is None else _tree_map(lambda leaf: leaf[k], us)
        x = step(f, x, u_eff, t0 + k * dt, dt)
        if save_trajectory:
            states.append(x)
    if save_trajectory:
        return x, _tree_map(lambda *leaves: torch.stack(leaves, dim=0), *states)
    return x


def integrate_rosenbrock(*args, **kwargs):
    """Not ported yet: the linearly implicit ROS2-W integrator."""
    raise NotImplementedError(
        "integrate_rosenbrock is not ported yet; see ROADMAP.md, slice 2b"
        " ('integrate_rosenbrock and rosenbrock_operator').")


def rosenbrock_operator(*args, **kwargs):
    """Not ported yet: the stage operator of the ROS2-W integrator."""
    raise NotImplementedError(
        "rosenbrock_operator is not ported yet; see ROADMAP.md, slice 2b"
        " ('integrate_rosenbrock and rosenbrock_operator').")
