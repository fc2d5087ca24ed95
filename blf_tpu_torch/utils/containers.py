"""Container utilities: trees of tensors, flat views and bounded flattening.

Counterpart of ``blf_tpu/utils/containers.py``; everything of it is ported:
:class:`FlatView` (``read``, and ``write`` out of place), :func:`make_view`,
:func:`same_structure`, :func:`is_resizable_like`, :func:`tree_size`,
:func:`tree_concat`, :func:`flatten_bounded` and :func:`unflatten_bounded`.

JAX's pytrees have no torch counterpart, so this module also holds a small
tree flatten of its own (:func:`tree_flatten`, :func:`tree_unflatten`,
:func:`tree_flatten_with_path`, :func:`tree_map`): NamedTuples, tuples,
lists and dicts are nodes, ``None`` is an empty node, anything else is a
leaf. The leaf order and the path strings are JAX's (NamedTuple fields in
order as ``.name``, sequence items as ``[i]``, dict keys sorted, as
``['key']``), so that a checkpoint (:mod:`blf_tpu_torch.utils.checkpoint`)
written by either package lists the same leaves in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "TreeDef",
    "tree_flatten",
    "tree_flatten_with_path",
    "tree_unflatten",
    "tree_leaves",
    "tree_map",
    "FlatView",
    "make_view",
    "same_structure",
    "is_resizable_like",
    "flatten_bounded",
    "unflatten_bounded",
    "tree_size",
    "tree_concat",
]


class TreeDef(NamedTuple):
    """The structure of a tree: ``kind`` is ``"leaf"``, ``"none"``,
    ``"namedtuple"``, ``"tuple"``, ``"list"`` or ``"dict"``; ``meta`` the
    NamedTuple's class or the dict's sorted keys; ``children`` the TreeDefs
    of the items."""

    kind: str
    meta: Any
    children: Tuple["TreeDef", ...]


_LEAF = TreeDef("leaf", None, ())


def _items(tree) -> Tuple[str, Any, List[Tuple[str, Any]]]:
    """(kind, meta, [(path key, child)]) of a node; kind "leaf" for a leaf."""
    if tree is None:
        return "none", None, []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return "namedtuple", type(tree), [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return type(tree).__name__, None, [(f"[{i}]", v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, [(f"[{k!r}]", tree[k]) for k in keys]
    return "leaf", None, []


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[str, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)``, paths as ``jax.tree_util.keystr``
    writes them."""
    kind, meta, items = _items(tree)
    if kind == "leaf":
        return [("", tree)], _LEAF
    leaves, children = [], []
    for key, child in items:
        sub, treedef = tree_flatten_with_path(child)
        leaves.extend((key + path, leaf) for path, leaf in sub)
        children.append(treedef)
    return leaves, TreeDef(kind, meta, tuple(children))


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    leaves, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in leaves], treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        children = [build(c) for c in td.children]
        if td.kind == "namedtuple":
            return td.meta(*children)
        if td.kind == "dict":
            return dict(zip(td.meta, children))
        return tuple(children) if td.kind == "tuple" else children

    out = build(treedef)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of the same structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, td in others:
        if td != treedef:
            raise ValueError(f"tree structures differ: {treedef} and {td}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *(o[0] for o in others))])


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _dtype(x):
    return x.dtype if hasattr(x, "dtype") else np.result_type(x)


def _size(x) -> int:
    """Elements of a leaf; a leaf with none counts as one, as in the reference."""
    return int(np.prod(_shape(x)) or 1)


class FlatView(NamedTuple):
    """Non-owning window ``flat[..., offset : offset + size]`` reshaped to
    ``shape``: no storage of its own, valid for any tensor whose last axis
    covers it, pure index arithmetic."""

    offset: int
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def read(self, flat: torch.Tensor) -> torch.Tensor:
        window = flat[..., self.offset:self.offset + self.size]
        return window.reshape(window.shape[:-1] + self.shape)

    def write(self, flat: torch.Tensor, value) -> torch.Tensor:
        """A copy of ``flat`` with the window set to ``value`` (broadcast)."""
        value = torch.as_tensor(value, dtype=flat.dtype, device=flat.device)
        window = value.reshape(value.shape[:value.dim() - len(self.shape)] + (self.size,))
        out = flat.clone()
        out[..., self.offset:self.offset + self.size] = window
        return out


def make_view(layout: Dict[str, Tuple[int, ...]]) -> Tuple[Dict[str, FlatView], int]:
    """Named views over one flat buffer from a ``name -> shape`` layout;
    returns ``(views, total_size)``."""
    views: Dict[str, FlatView] = {}
    offset = 0
    for name, shape in layout.items():
        v = FlatView(offset, tuple(shape))
        views[name] = v
        offset += v.size
    return views, offset


def same_structure(a, b) -> bool:
    """True iff two trees have the same structure and leaf shapes/dtypes."""
    la, ta = tree_flatten(a)
    lb, tb = tree_flatten(b)
    return ta == tb and all(_shape(x) == _shape(y) and _dtype(x) == _dtype(y)
                            for x, y in zip(la, lb))


def is_resizable_like(x) -> bool:
    """Host containers (list, bytearray, numpy array) are resizable; tensors
    and tuples are not."""
    return isinstance(x, (list, bytearray, np.ndarray))


def tree_size(tree) -> int:
    """Total number of scalar elements in a tree."""
    return sum(_size(leaf) for leaf in tree_leaves(tree))


def tree_concat(tree) -> torch.Tensor:
    """Flatten a tree of tensors into one 1-D tensor (leaf order)."""
    return torch.cat([torch.as_tensor(leaf).reshape(-1) for leaf in tree_leaves(tree)])


def flatten_bounded(tree, capacity: int, fill=0.0):
    """Flatten into a fixed-``capacity`` padded vector, with the actual size:
    ``(padded, n)``. Raises if the tree holds more than ``capacity``."""
    flat = tree_concat(tree)
    n = flat.shape[-1]
    if n > capacity:
        raise ValueError(f"tree size {n} exceeds capacity {capacity}")
    padded = torch.full((capacity,), fill, dtype=flat.dtype, device=flat.device)
    padded[:n] = flat
    return padded, n


def unflatten_bounded(example, padded: torch.Tensor):
    """Inverse of :func:`flatten_bounded` given an example tree (its leading
    ``tree_size(example)`` entries are consumed)."""
    leaves, treedef = tree_flatten(example)
    out, k = [], 0
    for leaf in leaves:
        size = _size(leaf)
        dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf).dtype
        out.append(padded[k:k + size].reshape(_shape(leaf)).to(dtype))
        k += size
    return tree_unflatten(treedef, out)
