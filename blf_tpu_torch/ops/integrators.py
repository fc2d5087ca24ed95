"""Fixed-step ODE integrators over nested-tuple states.

Counterpart of ``blf_tpu/ops/integrators.py``; everything of it is ported:
the explicit steps (``forward_euler_step``, ``midpoint_step``, ``rk4_step``,
``integrate``) and the stiff ROS2-W integrator (``integrate_rosenbrock``,
``rosenbrock_operator``).

A dynamics function is a pure function ``f(state, input, t) -> dstate`` where
``state`` and ``dstate`` are trees of tensors of one structure: a tensor, or
a (named) tuple, list or dict of such trees. The reference's ``lax.scan``
over steps is a Python loop here; every step is a handful of tensor ops over
whatever leading batch axes the leaves carry.

The ROS2-W integrator works on the state flattened to one vector a lane,
in the order of the reference's ``ravel_pytree``: leaves in declaration
order (dict keys sorted), each row-major. The first leaf is taken to be a
vector a lane, so its leading axes are the batch: a ``FloatingBaseState``
of the 23-DoF humanoid becomes (..., 64) = 6 + 23 + 3 + 9 + 23.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Tuple

import torch

__all__ = [
    "forward_euler_step",
    "midpoint_step",
    "rk4_step",
    "STEP_FUNCTIONS",
    "integrate",
    "integrate_rosenbrock",
    "rosenbrock_operator",
    "flatten_state",
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


def _leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves in ``ravel_pytree`` order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in _leaves(node)]
    raise TypeError(f"unsupported state node {type(tree).__name__}")


def _rebuild(tree, parts):
    """``tree``'s structure with its leaves taken in order from ``parts``."""
    if isinstance(tree, torch.Tensor):
        return next(parts)
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], parts) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):       # NamedTuple
        return type(tree)(*(_rebuild(node, parts) for node in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(node, parts) for node in tree)
    raise TypeError(f"unsupported state node {type(tree).__name__}")


def flatten_state(x) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """``(v, unflatten)``: the state as one vector a lane, (..., D), and the
    inverse map. ``unflatten`` takes any leading axes in front of D (a batch
    of tangents, for instance) and gives them to every leaf."""
    leaves = _leaves(x)
    batch = tuple(leaves[0].shape[:-1])
    shapes = [tuple(leaf.shape[len(batch):]) for leaf in leaves]
    sizes = [math.prod(shape) for shape in shapes]
    v = torch.cat([leaf.reshape(batch + (-1,)) for leaf in leaves], dim=-1)

    def unflatten(flat: torch.Tensor):
        lead = tuple(flat.shape[:-1])
        parts = torch.split(flat, sizes, dim=-1)
        return _rebuild(x, iter(p.reshape(lead + s) for p, s in zip(parts, shapes)))

    return v, unflatten


def _matvec(m, v):
    return torch.einsum("...ij,...j->...i", m, v)


def integrate_rosenbrock(
    f: DynamicsFn,
    x0,
    *,
    dt: float,
    num_steps: int,
    u=None,
    t0: float = 0.0,
    gamma: Optional[float] = None,
    operator: Optional[torch.Tensor] = None,
):
    """Stiff integrator: 2nd-order Rosenbrock-W (ROS2) with a **frozen**
    state Jacobian, L-stable in the linearized modes::

        J   = df/dx at x0
        Mi  = (I - gamma dt J)^-1       (one inverse, reused by every substep)
        k1  = Mi f(x)
        k2  = Mi (f(x + dt k1) - 2 k1)
        x+  = x + dt (3 k1 + k2) / 2    (gamma = 1 + 1/sqrt 2: R(inf) = 0, order 2)

    Each substep costs two dynamics evaluations and two (D, D) matrix-vector
    products a lane. Freezing J across the call (a W-method) keeps the
    linear stability of the stiff contact modes, which move on pose
    timescales. Constant input ``u`` only. Pass ``operator`` (from
    :func:`rosenbrock_operator`, (..., D, D)) to reuse a lagged stage
    operator instead of recomputing J at ``x0``.
    """
    if gamma is None:
        gamma = 1.0 + 2.0 ** -0.5
    flat0, unflatten = flatten_state(x0)

    def ff(v, t):
        return flatten_state(f(unflatten(v), u, t))[0]

    if operator is None:
        operator = rosenbrock_operator(f, x0, u=u, dt=dt, t0=t0, gamma=gamma)
    v = flat0
    for k in range(num_steps):
        t = t0 + k * dt
        k1 = _matvec(operator, ff(v, t))
        k2 = _matvec(operator, ff(v + dt * k1, t + dt) - 2.0 * k1)
        v = v + dt * (1.5 * k1 + 0.5 * k2)
    return unflatten(v)


def rosenbrock_operator(
    f: DynamicsFn,
    x,
    *,
    u=None,
    dt,
    t0=0.0,
    gamma: Optional[float] = None,
) -> torch.Tensor:
    """The ROS2 stage operator ``(I - gamma dt J)^-1`` (..., D, D) at state
    ``x``; ``dt`` must match the substep size of the consuming calls.

    ``J`` is one forward-mode pass of ``torch.func.jvp`` over D tangents at
    once: the identity basis rides a new leading axis of the state, so ``f``
    sees a batch (D, ...) and must broadcast whatever it closes over against
    it (every function of the port does). ``J`` of lane b is
    ``out[:, b, :]`` transposed. The inverse is the library's, as the
    reference's ``jnp.linalg.inv`` is XLA's.
    """
    if gamma is None:
        gamma = 1.0 + 2.0 ** -0.5
    flat, unflatten = flatten_state(x)
    D = flat.shape[-1]
    dtype, device = flat.dtype, flat.device

    def ff(v):
        return flatten_state(f(unflatten(v), u, t0))[0]

    eye = torch.eye(D, dtype=dtype, device=device)
    primal = flat.expand((D,) + tuple(flat.shape)).contiguous()
    tangent = eye.reshape((D,) + (1,) * (flat.dim() - 1) + (D,)).expand_as(primal)
    _, columns = torch.func.jvp(ff, (primal,), (tangent.contiguous(),))
    J = columns.movedim(0, -1)                              # (..., D, D)
    step = (torch.tensor(gamma, dtype=dtype) * torch.tensor(dt, dtype=dtype)).item()
    return torch.linalg.inv(eye - step * J)
