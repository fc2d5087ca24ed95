"""Checkpoint / resume: snapshots of trees of tensors (fleet and estimator
state) at sweep granularity.

Counterpart of ``blf_tpu/utils/checkpoint.py``'s ``.npz`` backend; ported:
:func:`save_checkpoint`, :func:`load_checkpoint` and :func:`checkpoint_step`.
The on-disk format is the reference's: the leaves as ``leaf_0``,
``leaf_1``, ... of one compressed ``.npz`` in the leaf order of the tree
flatten (:func:`blf_tpu_torch.utils.containers.tree_flatten`, JAX's order),
and beside it ``<path>.meta.json`` with ``num_leaves``, ``paths``,
``treedef`` (a description; loading does not read it) and ``step``. So a
file either package writes loads in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from blf_tpu_torch.utils.containers import tree_flatten, tree_flatten_with_path, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_step"]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, *, step: Optional[int] = None) -> str:
    """Write a snapshot of ``tree`` to ``path`` (``.npz`` + structure
    sidecar). Device tensors are copied to the host once."""
    leaves, treedef = tree_flatten_with_path(tree)
    arrays = {f"leaf_{i}": _host(leaf) for i, (_, leaf) in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez_compressed(path, **arrays)
    meta = {
        "num_leaves": len(leaves),
        "paths": [p for p, _ in leaves],
        "treedef": repr(treedef),
        "step": step,
    }
    with open(path + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, example_tree) -> Any:
    """Restore a snapshot into the structure of ``example_tree``: each leaf
    on the example leaf's device and in its dtype. The shapes are checked
    leaf by leaf; a count or shape mismatch raises instead of truncating."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        leaves_e, treedef = tree_flatten(example_tree)
        stored = [data[f"leaf_{i}"] for i in range(len(data.files))]
        if len(stored) != len(leaves_e):
            raise ValueError(
                f"checkpoint has {len(stored)} leaves, expected {len(leaves_e)}")
        out = []
        for i, (exp, got) in enumerate(zip(leaves_e, stored)):
            shape = tuple(exp.shape) if hasattr(exp, "shape") else np.shape(exp)
            if shape != got.shape:
                raise ValueError(f"leaf {i}: shape {got.shape} != expected {shape}")
            if isinstance(exp, torch.Tensor):
                out.append(torch.from_numpy(np.array(got)).to(device=exp.device,
                                                              dtype=exp.dtype))
            else:
                out.append(np.asarray(got, dtype=np.result_type(exp)))
        return tree_unflatten(treedef, out)


def checkpoint_step(path: str) -> Optional[int]:
    """The step recorded at save time (None if absent)."""
    meta_path = (path if path.endswith(".npz") else path + ".npz") + ".meta.json"
    try:
        with open(meta_path, "r", encoding="utf-8") as f:
            return json.load(f).get("step")
    except FileNotFoundError:
        return None
