"""Fleet-wide statistics and the tree reductions across ranks.

Counterpart of ``blf_tpu/parallel/collectives.py`` (``FleetStats``,
``reduce_fleet_stats``, ``psum_tree``, ``pmax_tree``). The reference's
``psum``/``pmax``/``all_gather`` over a named mesh axis are all-reduces and
all-gathers over that axis's process group (:func:`blf_tpu_torch.parallel.mesh.make_mesh`'s
``mesh.get_group(axis)``), called by every rank of the group.

The tree collectives are functional: they return new tensors and leave
their inputs untouched. The leaves of one dtype travel in one buffer, so a
tree costs one all-reduce or all-gather a dtype. :func:`pmax_tree` keeps a
NaN: ``gloo``'s MAX (``std::max``) and NCCL's drop a NaN or keep it
by the order of the operands, so each floating leaf carries a NaN flag
through the reduction and comes back NaN wherever any rank held one.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.distributed as dist

from blf_tpu_torch.utils.containers import tree_flatten, tree_unflatten

__all__ = ["FleetStats", "reduce_fleet_stats", "psum_tree", "pmax_tree", "all_gather_tree"]


class FleetStats(NamedTuple):
    """Global solver statistics for one control tick (0-dim tensors)."""

    num_scenarios: torch.Tensor     # total lanes
    num_converged: torch.Tensor     # lanes with converged QPs
    max_primal_residual: torch.Tensor
    max_dual_residual: torch.Tensor
    mean_objective: torch.Tensor


def _by_dtype(tree, collective):
    """``collective`` on one flat buffer a dtype of ``tree``'s leaves (a copy:
    the inputs stay untouched); the last axis of each result is cut back into
    the leaves, after any leading axes the collective added."""
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    out: List[torch.Tensor] = [None] * len(leaves)
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        idx = [i for i, x in enumerate(leaves) if x.dtype == dtype]
        flat = collective(torch.cat([leaves[i].reshape(-1) for i in idx]))
        offset = 0
        for i in idx:
            size = leaves[i].numel()
            out[i] = flat[..., offset:offset + size].reshape(flat.shape[:-1] + leaves[i].shape)
            offset += size
    return tree_unflatten(treedef, out)


def _all_reduce(flat: torch.Tensor, group, op) -> torch.Tensor:
    n = flat.numel()
    nan_flags = op == dist.ReduceOp.MAX and flat.dtype.is_floating_point
    if nan_flags:
        isnan = torch.isnan(flat)
        flat = torch.cat([torch.where(isnan, float("-inf"), flat), isnan.to(flat.dtype)])
    dist.all_reduce(flat, op=op, group=group)
    return torch.where(flat[n:] > 0, float("nan"), flat[:n]) if nan_flags else flat


def _all_gather(flat: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    return torch.stack(parts)


def psum_tree(tree, group):
    """Sum of every leaf over the ranks of ``group`` (the reference's ``psum``
    over a mesh axis); every rank gets the same values."""
    return _by_dtype(tree, lambda flat: _all_reduce(flat, group, dist.ReduceOp.SUM))


def pmax_tree(tree, group):
    """Elementwise max of every leaf over the ranks of ``group`` (the
    reference's ``pmax``), NaN wherever any rank holds a NaN."""
    return _by_dtype(tree, lambda flat: _all_reduce(flat, group, dist.ReduceOp.MAX))


def all_gather_tree(tree, group):
    """Every rank's leaves of ``group``, each stacked on a new leading axis in
    rank order (the reference's ``all_gather`` over a mesh axis); one
    all-gather a dtype."""
    return _by_dtype(tree, lambda flat: _all_gather(flat, group))


def reduce_fleet_stats(qp_solution, group=None) -> FleetStats:
    """Reduce a per-lane :class:`blf_tpu_torch.mpc.qp.QPSolution` to fleet
    statistics: over its own lanes with ``group=None``, and over the lanes of
    every rank of ``group`` otherwise (the reference's ``psum``/``pmax`` over
    the data axis; the result is the same on every rank). Counts are
    float32, as in the reference."""
    conv = qp_solution.converged
    n = torch.full((), float(conv.numel()), dtype=torch.float32, device=conv.device)
    sums = (n, conv.to(torch.float32).sum(), qp_solution.objective.sum())
    maxes = (qp_solution.primal_residual.max(), qp_solution.dual_residual.max())
    if group is not None:
        sums, maxes = psum_tree(sums, group), pmax_tree(maxes, group)
    return FleetStats(
        num_scenarios=sums[0],
        num_converged=sums[1],
        max_primal_residual=maxes[0],
        max_dual_residual=maxes[1],
        mean_objective=sums[2] / sums[0],
    )
