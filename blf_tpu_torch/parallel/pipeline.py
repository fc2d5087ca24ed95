"""Pipeline parallelism: a GPipe-style microbatched stage pipeline over a mesh
axis.

Counterpart of ``blf_tpu/parallel/pipeline.py`` (``pipeline_stages``). ``S``
stages sit one a rank along a mesh axis; ``M`` microbatches enter at stage
0, and on every one of the ``M + S - 1`` ticks each rank applies its own
stage to the microbatch it holds and hands the result to the next rank by
one point-to-point exchange (``batch_isend_irecv``: neighbours only, no
all-to-all). After the ``S - 1``-tick fill all ranks compute at once on
consecutive microbatches and one finished microbatch leaves a tick; the
bubble is ``(S - 1) / (M + S - 1)``.

The reference runs every stage under ``lax.switch`` on every tick, bubble
ticks included, on whatever its buffer holds. Here the schedule is known on
the host, so rank ``i`` runs ``stage_fns[i]`` only on the ticks that carry a
microbatch (``i .. i + M - 1``) and exchanges only then: a stage never sees
the zero carrier of the fill. All stages map a carrier pytree to one of the
same structure and shapes; the last stage's outputs are broadcast from it,
so every rank of the axis returns them all.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from blf_tpu_torch.parallel.mesh import axis_index, axis_size, global_ranks
from blf_tpu_torch.utils.containers import tree_flatten, tree_unflatten

__all__ = ["pipeline_stages"]


def pipeline_stages(stage_fns: Sequence[Callable], mesh, axis_name: str):
    """Build a pipelined ``fn(microbatches) -> outputs`` over ``mesh``'s axis
    ``axis_name``.

    ``stage_fns``: one function a rank of the axis; each maps a carrier
    pytree to a same-shaped carrier pytree. The composed semantics are
    ``f_{S-1} o ... o f_0`` applied to each microbatch on its own.

    ``microbatches``: a carrier pytree with a leading microbatch axis of
    length ``M`` on every leaf, the same on every rank of the axis. Every
    rank of the axis calls ``fn`` and gets the whole result.
    """
    n_stages = axis_size(mesh, axis_name)
    if len(stage_fns) != n_stages:
        raise ValueError(
            f"{len(stage_fns)} stage fns for a {n_stages}-device '{axis_name}' axis")
    fns = tuple(stage_fns)

    def run(microbatches):
        idx = axis_index(mesh, axis_name)
        group, peers = mesh.get_group(axis_name), global_ranks(mesh, axis_name)
        leaves, treedef = tree_flatten(microbatches)
        M = leaves[0].shape[0]
        fn = fns[idx]
        carrier = lambda flat: tree_unflatten(treedef, flat)
        # every rank of the group enters one collective first: a batched
        # exchange that involves only some of the group's ranks is defined
        # under nccl only if it is not the group's first collective
        dist.all_reduce(torch.zeros(1, device=leaves[0].device), group=group)
        held = None                                # what this rank received last tick
        done = []                                  # the last stage's outputs, in order
        for t in range(M + n_stages - 1):
            m = t - idx                            # this rank's microbatch on tick t
            y = None
            if 0 <= m < M:
                x = carrier([leaf[m] for leaf in leaves]) if idx == 0 else held
                y = tree_flatten(fn(x))[0]
                if idx == n_stages - 1:
                    done.append(y)
            # hand y to rank idx + 1; take what rank idx - 1 finished on this tick
            ops, incoming = [], None
            if y is not None and idx < n_stages - 1:
                ops += [dist.P2POp(dist.isend, a.contiguous(), peers[idx + 1], group) for a in y]
            if idx > 0 and 0 <= t - (idx - 1) < M:
                incoming = [torch.empty_like(leaf[0]) for leaf in leaves]
                ops += [dist.P2POp(dist.irecv, a, peers[idx - 1], group) for a in incoming]
            for work in (dist.batch_isend_irecv(ops) if ops else []):
                work.wait()
            if incoming is not None:
                held = carrier(incoming)
        # replicate the result: the last stage broadcasts what it finished
        if idx == n_stages - 1:
            out = [torch.stack(parts) for parts in zip(*done)]
        else:
            out = [torch.empty_like(leaf) for leaf in leaves]
        for a in out:
            dist.broadcast(a, src=peers[n_stages - 1], group=group)
        return carrier(out)

    return run
