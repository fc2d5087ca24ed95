"""The ``Advanceable`` protocol: incremental computation as pure steps.

Counterpart of ``blf_tpu/ops/advanceable.py``; everything of it is ported.
The convention is ``step(carry, *inputs) -> (carry', output)``: the carry is
the explicit state (a tree of tensors, batched on leading axes), the output
is the tick's value, and validity is data (status tensors), not a method.
Every stateful function of the port follows it (``rls_step``, the fleet
tick of ``make_fleet_step``, the stack's tick, ``momentum_observer_step``).

- :class:`Advanceable`: a ``typing.Protocol`` for static and duck typing;
- :func:`advance_scan`: drive a step over a tick sequence, a Python loop
  whose outputs are stacked on a new leading axis (the reference's
  ``lax.scan``; its ``unroll`` is a compiler hint with no meaning here);
- :func:`check_advanceable`: the contract check, one call of the step.
  The reference traces it abstractly (``jax.eval_shape``); torch has no
  abstract evaluation that every step accepts, so the step runs once.
"""

from __future__ import annotations

from typing import Any, Optional, Protocol, Tuple, runtime_checkable

import torch

from blf_tpu_torch.utils.containers import tree_flatten, tree_unflatten

__all__ = ["Advanceable", "advance_scan", "check_advanceable"]


@runtime_checkable
class Advanceable(Protocol):
    """Anything callable as ``step(carry, *inputs) -> (carry', output)``."""

    def __call__(self, carry: Any, *inputs: Any) -> Tuple[Any, Any]: ...


def advance_scan(step: Advanceable, carry: Any, xs: Any = None, *,
                 length: Optional[int] = None):
    """Run ``step`` over a tick sequence; returns ``(final_carry, outputs)``.

    ``xs`` is a tree of per-tick inputs with a leading time axis (or
    ``None`` with ``length`` for autonomous systems; the step is then
    called as ``step(carry)``). The per-tick slice is passed as ONE
    argument, whatever its tree structure; steps taking several tensors take
    them as a tuple. The outputs are stacked along a new leading axis.
    """
    if xs is None:
        if length is None:
            raise ValueError("advance_scan needs xs or length")
        ticks = [None] * length
    else:
        leaves, treedef = tree_flatten(xs)
        n = leaves[0].shape[0]
        if length is not None and length != n:
            raise ValueError(f"length {length} does not match the inputs' {n} ticks")
        ticks = [tree_unflatten(treedef, [leaf[t] for leaf in leaves]) for t in range(n)]
    outputs = []
    for x in ticks:
        carry, out = step(carry) if x is None else step(carry, x)
        outputs.append(out)
    if not outputs:
        return carry, None
    _, out_def = tree_flatten(outputs[0])
    stacked = [torch.stack([torch.as_tensor(leaf) for leaf in column])
               for column in zip(*(tree_flatten(o)[0] for o in outputs))]
    return carry, tree_unflatten(out_def, stacked)


def _signature(leaf):
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    return shape, getattr(leaf, "dtype", type(leaf))


def check_advanceable(step: Advanceable, carry: Any, *inputs: Any) -> None:
    """Raise ``TypeError`` unless ``step`` honours the contract:

    1. the step returns a 2-tuple ``(carry', output)``;
    2. ``carry'`` has exactly ``carry``'s tree structure, shapes and dtypes
       (what a scan over ticks needs).
    """
    out = step(carry, *inputs)
    if not (isinstance(out, tuple) and len(out) == 2):
        raise TypeError(f"step must return (carry, output); got {type(out).__name__}")
    got_leaves, got_tree = tree_flatten(out[0])
    want_leaves, want_tree = tree_flatten(carry)
    if got_tree != want_tree:
        raise TypeError(f"carry treedef changed across step: {want_tree} -> {got_tree}")
    for g, w in zip(got_leaves, want_leaves):
        (gs, gd), (ws, wd) = _signature(g), _signature(w)
        if gs != ws or gd != wd:
            raise TypeError(f"carry leaf changed across step: {ws}/{wd} -> {gs}/{gd}"
                            " (scan requires a stable carry)")
