"""Device mesh and batch placement: the port's distribution substrate.

Counterpart of ``blf_tpu/parallel/mesh.py`` (``init_distributed``,
``make_mesh``, ``shard_batch``, ``replicate``, ``data_parallel_specs``).

The reference writes its multi-device programs under ``shard_map``: manual
SPMD over a named mesh. The port keeps that model on ``torch.distributed``:
one process a device, every rank holds its own local tensors and calls
collectives on the process groups of a
:class:`torch.distributed.device_mesh.DeviceMesh`. The solvers never go
through DTensor dispatch; :func:`data_parallel_specs` only names the
placements a caller would hand to ``distribute_tensor``.

The mesh is ``(data, model)``: scenario data-parallelism over ``data``, and
over ``model`` a disturbance ensemble (the fleet tick) or the blocks of one
solve (the row-sharded QP, the horizon-sharded LQR, the stream-sharded RLS,
the pipeline's stages). The axis helpers :func:`axis_index` and
:func:`axis_size` are the counterparts of ``jax.lax.axis_index`` and
``mesh.shape[axis]``.

Device rule: ``device=None`` means the GPU (``nccl``) and raises without one;
``device="cpu"`` runs on ``gloo``.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from blf_tpu_torch.parallel.collectives import all_gather_tree
from blf_tpu_torch.utils.containers import tree_map
from blf_tpu_torch.utils.device import resolve_device

__all__ = ["init_distributed", "make_mesh", "shard_batch", "gather_batch", "replicate",
           "data_parallel_specs", "axis_index", "axis_size", "mesh_device", "global_ranks",
           "DATA_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _bind(device: torch.device, local_rank: int) -> None:
    """Give this process its own card before ``nccl`` starts on it."""
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout: Optional[timedelta] = None,
) -> int:
    """Start this process's ``torch.distributed`` world; returns its rank.

    Idempotent: once a world is up it only returns the rank. Otherwise:

    - ``coordinator_address``, ``num_processes`` and ``process_id`` given: the
      world meets there. A bare ``host:port`` is read as ``tcp://host:port``;
      any URL ``init_process_group`` takes (``file://...`` too) is passed on.
    - none given, and ``torchrun``'s ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``
      set: the world those name (``env://``).
    - none given and no ``torchrun``: a world of one on an in-process store,
      which needs no port (the reference's single-process return of 0).

    The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for
    ``cpu``. ``timeout`` bounds every collective of the world.
    """
    if dist.is_initialized():
        return dist.get_rank()
    device = resolve_device(device)
    backend = _backend(device)
    extra = {} if timeout is None else {"timeout": timeout}
    given = (coordinator_address, num_processes, process_id)
    env = os.environ
    if any(v is not None for v in given):
        if any(v is None for v in given):
            raise ValueError("init_distributed takes coordinator_address, num_processes and"
                             " process_id together")
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        _bind(device, process_id)
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, **extra)
    elif all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        _bind(device, int(env.get("LOCAL_RANK", env["RANK"])))
        dist.init_process_group(backend, init_method="env://", **extra)
    else:
        _bind(device, 0)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **extra)
    return dist.get_rank()


def make_mesh(
    n_devices: Optional[int] = None,
    model_axis: int = 1,
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS),
    *,
    device=None,
) -> DeviceMesh:
    """A ``(n_devices // model_axis, model_axis)`` mesh over ranks
    ``0 .. n_devices - 1``, named ``axis_names``.

    ``n_devices`` defaults to the whole world; ``model_axis`` is how many
    ranks each scenario shard spans (1 = pure data parallelism). Starts a
    world of one (:func:`init_distributed`) if none is up. Every rank of the
    world must call it, those outside a smaller mesh too: each of the mesh's
    process groups is made by all ranks together. A rank outside the mesh
    gets a mesh whose ``get_coordinate()`` is ``None``.
    """
    device = resolve_device(device)
    init_distributed(device=device)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if n_devices % model_axis != 0:
        raise ValueError("n_devices must be divisible by model_axis")
    grid = torch.arange(n_devices).reshape(n_devices // model_axis, model_axis)
    return DeviceMesh(device.type, grid, mesh_dim_names=tuple(axis_names))


def axis_index(mesh: DeviceMesh, axis_name: str) -> int:
    """This rank's coordinate along ``axis_name`` (``jax.lax.axis_index``)."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return mesh.get_local_rank(axis_name)


def axis_size(mesh: DeviceMesh, axis_name: str) -> int:
    """The number of ranks along ``axis_name`` (``mesh.shape[axis_name]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis_name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """Where this rank's tensors of the mesh live."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_parallel_specs(mesh: DeviceMesh):
    """``(sharded, replicated)`` DTensor placements for scenario-batched
    tensors: the leading axis split over the mesh's first axis
    (``Shard(0)``) and copies over every other, and copies everywhere. One
    placement a mesh axis: ``(Shard(0), Replicate())`` and ``(Replicate(),
    Replicate())`` on a ``(data, model)`` mesh."""
    from torch.distributed.tensor import Replicate, Shard

    rest = (Replicate(),) * (mesh.ndim - 1)
    return (Shard(0),) + rest, (Replicate(),) + rest


def shard_batch(pytree, mesh: DeviceMesh, axis_name: str = DATA_AXIS):
    """This rank's slice of every leaf's leading axis, by its coordinate on
    ``axis_name``, on the mesh's device (a view where no copy is needed).
    The leading axis must divide by the axis size."""
    index, size = axis_index(mesh, axis_name), axis_size(mesh, axis_name)
    device = mesh_device(mesh)

    def cut(leaf):
        leaf = torch.as_tensor(leaf)
        if leaf.shape[0] % size:
            raise ValueError(f"leading axis {leaf.shape[0]} not divisible by the {size} ranks"
                             f" of axis {axis_name!r}")
        block = leaf.shape[0] // size
        return leaf[index * block:(index + 1) * block].to(device)

    return tree_map(cut, pytree)


def gather_batch(pytree, mesh: DeviceMesh, axis_name: str = DATA_AXIS):
    """Inverse of :func:`shard_batch`: every leaf's blocks of all ranks
    along ``axis_name``, concatenated on the leading axis, on every rank of
    the axis (one all-gather a dtype)."""
    return tree_map(lambda g: g.flatten(0, 1), all_gather_tree(pytree, mesh.get_group(axis_name)))


def replicate(pytree, mesh: DeviceMesh):
    """The whole pytree on this rank's device of the mesh (every rank holds
    all of it)."""
    device = mesh_device(mesh)
    return tree_map(lambda leaf: torch.as_tensor(leaf).to(device), pytree)


def global_ranks(mesh: DeviceMesh, axis_name: str) -> Sequence[int]:
    """World ranks of this rank's group along ``axis_name``, by coordinate
    (the peers of point-to-point operations)."""
    return dist.get_process_group_ranks(mesh.get_group(axis_name))
