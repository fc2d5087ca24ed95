"""Log-depth associative scan in torch ops.

No module of ``blf_tpu`` holds it: the reference calls
``jax.lax.associative_scan``, which has no torch counterpart. This is the
same recursion (adjacent pairs combined, the scan of those gives the odd
prefixes, one more combine the even ones), used by the parallel-in-time RLS
(:mod:`blf_tpu_torch.estimators.rls_parallel`) and by the parallel Riccati
value passes (:mod:`blf_tpu_torch.mpc.riccati`).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

__all__ = ["associative_scan"]

Combine = Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], Sequence[torch.Tensor]]


def _prefix_scan(fn: Combine, elems: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _prefix_scan(fn, tuple(reduced))
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        full = torch.empty((n,) + tuple(ev.shape[1:]), dtype=ev.dtype, device=ev.device)
        full[0] = e[0]
        full[2::2] = ev
        full[1::2] = od
        out.append(full)
    return tuple(out)


def associative_scan(fn: Combine, elems: Sequence[torch.Tensor], *,
                     reverse: bool = False) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan along axis 0 of every tensor of ``elems`` with the
    associative ``fn(earlier, later)``, in O(log T) depth.

    ``reverse=False``: ``out[k] = e_0 . e_1 . ... . e_k``. ``reverse=True``:
    the suffixes, ``out[k] = e_k . e_{k+1} . ... . e_last``: the inputs are
    flipped, prefix-scanned with ``fn``'s arguments swapped, and flipped
    back, so ``fn`` still sees ``(earlier, later)`` in the original order.
    (``jax.lax.associative_scan(reverse=True)`` does not swap them: it hands
    its ``fn`` the later element first, which is why the reference's
    ``_suffix_scan`` passes a swapped combine. The products are the same.)
    """
    elems = tuple(elems)
    if not reverse:
        return _prefix_scan(fn, elems)
    flipped = tuple(torch.flip(e, (0,)) for e in elems)
    scanned = _prefix_scan(lambda a, b: fn(b, a), flipped)
    return tuple(torch.flip(s, (0,)) for s in scanned)
