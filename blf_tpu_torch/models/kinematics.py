"""Fixed-topology kinematic trees: spec, forward kinematics, Jacobians.

Counterpart of ``blf_tpu/models/kinematics.py``; everything of it is ported.
:class:`KinematicTree`, :class:`KinematicTreeBuilder` and :class:`JointType`
are the port's own copy of the reference's host-side numpy spec (same field
names, so a tree built on either side describes the same robot).

Conventions:

- **Mixed (hybrid) representation** everywhere: a frame's 6D velocity is
  ``[pdot; omega]`` with both parts in world axes, at the frame origin.
- Generalized velocity ``nu = [base twist (mixed, 6); joint rates (n)]``.
- The tree spec is static host data. Its constants are uploaded **once** per
  (tree, device, dtype) by :func:`tree_constants` and reused by every call;
  ``dof_index`` and ``ancestor_mask`` are computed once per tree.

Where the reference's functions are single-sample and ``vmap``-ped, these
take the batch as leading dimensions written out: ``base_position`` (..., 3),
``base_rotation`` (..., 3, 3), ``q`` (..., n), and work unbatched too. The
link axis comes after the batch: ``LinkPoses.position`` is (..., L, 3). No
function writes in place or leaves the device, so ``torch.func.jvp`` passes
through all of them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from blf_tpu_torch.ops.lie import skew, so3_exp
from blf_tpu_torch.ops.precision import f32_matmuls

__all__ = [
    "JointType",
    "KinematicTreeBuilder",
    "KinematicTree",
    "LinkPoses",
    "tree_constants",
    "forward_kinematics",
    "link_jacobians",
    "frame_pose",
    "frame_jacobian",
    "point_jacobian_columns",
]

FIXED, REVOLUTE, PRISMATIC = 0, 1, 2


class JointType:
    FIXED = FIXED
    REVOLUTE = REVOLUTE
    PRISMATIC = PRISMATIC


@dataclass(frozen=True, eq=False)
class KinematicTree:
    """Static articulated-tree description (URDF-lite).

    Link 0 is the floating base. ``parent[i] < i`` (topological order).
    Joint ``i`` connects ``parent[i]`` -> link ``i``: the joint frame sits at
    ``joint_position[i]``/``joint_rotation[i]`` in the parent frame, the link
    frame coincides with the joint frame at zero joint value, and the joint
    moves about/along ``axis[i]`` (joint-frame coordinates).

    Trees compare by identity: a tree carries its own cache of device
    constants (:func:`tree_constants`).
    """

    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    axis: np.ndarray            # (L, 3)
    joint_position: np.ndarray  # (L, 3)  parent-frame offset
    joint_rotation: np.ndarray  # (L, 3, 3) parent-frame orientation
    mass: np.ndarray            # (L,)
    com: np.ndarray             # (L, 3) link-frame CoM offset
    inertia: np.ndarray         # (L, 3, 3) about CoM, link frame
    link_names: Tuple[str, ...]
    frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = field(default_factory=dict)
    # name -> (link index, position offset, rotation offset), link-frame
    _constants: dict = field(default_factory=dict, init=False, repr=False)

    @property
    def num_links(self) -> int:
        return len(self.parent)

    @cached_property
    def dof_index(self) -> Tuple[int, ...]:
        """Joint-space column of each link's joint; -1 for fixed joints."""
        idx, k = [], 0
        for t in self.joint_type:
            if t == FIXED:
                idx.append(-1)
            else:
                idx.append(k)
                k += 1
        return tuple(idx)

    @cached_property
    def num_dofs(self) -> int:
        """Actuated DoFs (excludes the 6 base DoFs)."""
        return sum(1 for t in self.joint_type if t != FIXED)

    @property
    def nv(self) -> int:
        """Generalized-velocity size 6 + n."""
        return 6 + self.num_dofs

    @cached_property
    def ancestor_mask(self) -> np.ndarray:
        """(L, L) bool: ``mask[i, j]`` iff link j is on the path base -> link i
        (inclusive)."""
        L = self.num_links
        mask = np.zeros((L, L), dtype=bool)
        for i in range(L):
            j = i
            while j >= 0:
                mask[i, j] = True
                j = self.parent[j] if j > 0 else -1
        return mask

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    def frame_names(self) -> List[str]:
        return list(self.frames)


class KinematicTreeBuilder:
    """Imperative builder: ``add_link(...)`` then ``finalize()``."""

    def __init__(self, base_name: str = "base", base_mass: float = 1.0,
                 base_com=(0.0, 0.0, 0.0), base_inertia: Optional[np.ndarray] = None):
        self._names = [base_name]
        self._parent = [-1]
        self._jtype = [FIXED]
        self._axis = [np.array([0.0, 0.0, 1.0])]
        self._jpos = [np.zeros(3)]
        self._jrot = [np.eye(3)]
        self._mass = [float(base_mass)]
        self._com = [np.asarray(base_com, dtype=float)]
        self._inertia = [
            np.asarray(base_inertia, dtype=float) if base_inertia is not None
            else np.eye(3) * 0.01
        ]
        self._frames: Dict[str, Tuple[int, np.ndarray, np.ndarray]] = {}

    def add_link(
        self,
        name: str,
        parent: str,
        joint_type: int = REVOLUTE,
        axis=(0.0, 0.0, 1.0),
        joint_position=(0.0, 0.0, 0.0),
        joint_rotation: Optional[np.ndarray] = None,
        mass: float = 1.0,
        com=(0.0, 0.0, 0.0),
        inertia: Optional[np.ndarray] = None,
    ) -> "KinematicTreeBuilder":
        if name in self._names:
            raise ValueError(f"duplicate link name {name!r}")
        if parent not in self._names:
            raise ValueError(f"unknown parent link {parent!r}")
        self._names.append(name)
        self._parent.append(self._names.index(parent))
        self._jtype.append(joint_type)
        a = np.asarray(axis, dtype=float)
        if joint_type != FIXED:
            a = a / np.linalg.norm(a)
        self._axis.append(a)
        self._jpos.append(np.asarray(joint_position, dtype=float))
        self._jrot.append(
            np.asarray(joint_rotation, dtype=float) if joint_rotation is not None
            else np.eye(3)
        )
        self._mass.append(float(mass))
        self._com.append(np.asarray(com, dtype=float))
        self._inertia.append(
            np.asarray(inertia, dtype=float) if inertia is not None
            else np.eye(3) * 1e-3 * mass
        )
        return self

    def add_frame(self, name: str, link: str, position=(0.0, 0.0, 0.0),
                  rotation: Optional[np.ndarray] = None) -> "KinematicTreeBuilder":
        if name in self._frames:
            raise ValueError(f"duplicate frame name {name!r}")
        self._frames[name] = (
            self._names.index(link),
            np.asarray(position, dtype=float),
            np.asarray(rotation, dtype=float) if rotation is not None else np.eye(3),
        )
        return self

    def finalize(self) -> KinematicTree:
        return KinematicTree(
            parent=tuple(self._parent),
            joint_type=tuple(self._jtype),
            axis=np.stack(self._axis),
            joint_position=np.stack(self._jpos),
            joint_rotation=np.stack(self._jrot),
            mass=np.asarray(self._mass),
            com=np.stack(self._com),
            inertia=np.stack(self._inertia),
            link_names=tuple(self._names),
            frames=dict(self._frames),
        )


class LinkPoses(NamedTuple):
    """World pose of every link: ``position`` (..., L, 3), ``rotation`` (..., L, 3, 3)."""

    position: torch.Tensor
    rotation: torch.Tensor


def tree_constants(tree: KinematicTree, device, dtype) -> SimpleNamespace:
    """The tree's constants as tensors on ``device`` in ``dtype``.

    Made once per (tree, device, dtype) and kept on the tree: in eager
    PyTorch every ``torch.as_tensor(numpy_array, device=...)`` is a
    host-to-device copy, which the reference's ``jnp.asarray`` under ``jit``
    is not. Fields:

    ``axis`` (L, 3), ``joint_position`` (L, 3), ``joint_rotation`` (L, 3, 3),
    ``mass`` (L,), ``com`` (L, 3), ``inertia`` (L, 3, 3);
    ``movable`` (n,) long, link index of every DoF column, in column order
    (``dof_index`` increments in link order, so sorting by link IS the column
    order); ``axis_movable`` (n, 3); ``rev`` (n, 1) bool, revolute columns;
    ``onpath`` (L, n, 1), 1 where DoF column j moves link i;
    ``onpath_rev`` (L, n, 1), the same for revolute columns only;
    ``scatter`` (L, n), 1 where link i's own joint is DoF column j;
    ``rev_link``/``pri_link`` (L, 1) masks of links behind such a joint;
    ``frames``: name -> (link index, offset position (3,), offset rotation (3, 3)).
    """
    key = (torch.device(device), dtype)
    c = tree._constants.get(key)
    if c is not None:
        return c
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    L, n = tree.num_links, tree.num_dofs
    jm = np.array([j for j in range(L) if tree.joint_type[j] != FIXED], dtype=np.int64)
    rev = np.array([tree.joint_type[j] == REVOLUTE for j in jm], dtype=bool)
    onpath = tree.ancestor_mask[:, jm] if n else np.zeros((L, 0), dtype=bool)
    scatter = np.zeros((L, n))
    for i, k in enumerate(tree.dof_index):
        if k >= 0:
            scatter[i, k] = 1.0
    jt = np.asarray(tree.joint_type)
    c = SimpleNamespace(
        axis=as_t(tree.axis),
        joint_position=as_t(tree.joint_position),
        joint_rotation=as_t(tree.joint_rotation),
        mass=as_t(tree.mass),
        com=as_t(tree.com),
        inertia=as_t(tree.inertia),
        movable=torch.as_tensor(jm, device=device),
        axis_movable=as_t(tree.axis[jm]) if n else as_t(np.zeros((0, 3))),
        rev=torch.as_tensor(rev[:, None], device=device),
        onpath=as_t(onpath[..., None]),
        onpath_rev=as_t((onpath & rev[None, :])[..., None]),
        scatter=as_t(scatter),
        rev_link=as_t((jt == REVOLUTE)[:, None]),
        pri_link=as_t((jt == PRISMATIC)[:, None]),
        frames={name: (link, as_t(off_p), as_t(off_R))
                for name, (link, off_p, off_R) in tree.frames.items()},
    )
    tree._constants[key] = c
    return c


@f32_matmuls
def forward_kinematics(tree: KinematicTree, base_position, base_rotation, q) -> LinkPoses:
    """World poses of all links.

    ``base_position`` (..., 3), ``base_rotation`` (..., 3, 3), ``q`` (..., n).
    The joint transforms of all links are formed at once (one Rodrigues
    formula over the (..., L) axis); the loop over links only chains them.
    """
    c = tree_constants(tree, base_rotation.device, base_rotation.dtype)
    L = tree.num_links
    if L == 1:
        return LinkPoses(base_position[..., None, :], base_rotation[..., None, :, :])
    q_link = q @ c.scatter.T                                    # (..., L), 0 at fixed joints
    moved = q_link[..., None] * c.axis                          # (..., L, 3)
    # link frame in its parent's frame: rotation for revolute joints,
    # translation along the axis for prismatic ones, neither for fixed ones
    R_local = c.joint_rotation @ so3_exp(moved * c.rev_link)    # (..., L, 3, 3)
    p_local = c.joint_position + torch.einsum(
        "lij,...lj->...li", c.joint_rotation, moved * c.pri_link)
    positions = [base_position]
    rotations = [base_rotation]
    for i in range(1, L):
        p = tree.parent[i]
        Rp = rotations[p]
        rotations.append(Rp @ R_local[..., i, :, :])
        positions.append(positions[p] + (Rp @ p_local[..., i, :, None])[..., 0])
    return LinkPoses(torch.stack(positions, dim=-2), torch.stack(rotations, dim=-3))


def _joint_columns(tree: KinematicTree, poses: LinkPoses, c):
    """(..., n, 3) world axis and anchor point of every DoF column.

    The axis is fixed in the joint frame, which a revolute joint rotates only
    about the axis itself, so ``a_w = R_link a_local`` is exact; prismatic
    links translate, so the same holds.
    """
    R = poses.rotation.index_select(-3, c.movable)              # (..., n, 3, 3)
    axes = (R @ c.axis_movable[..., None])[..., 0]
    anchors = poses.position.index_select(-2, c.movable)
    return axes, anchors


def _base_rows(offset, dtype, device):
    """Base columns (..., 3, 6) linear and angular for points at ``offset``
    (..., 3) from the base origin: ``[[I, -skew(offset)]; [0, I]]``."""
    eye3 = torch.eye(3, dtype=dtype, device=device).expand(offset.shape[:-1] + (3, 3))
    base_lin = torch.cat([eye3, -skew(offset)], dim=-1)
    base_ang = torch.cat([torch.zeros_like(eye3), eye3], dim=-1)
    return base_lin, base_ang


def point_jacobian_columns(tree: KinematicTree, poses: LinkPoses, link_index: int,
                           point_w):
    """Mixed Jacobian (..., 6, 6+n) of the frame at world point ``point_w``
    (..., 3) rigidly attached to ``link_index``.

    Columns: base (6) ``[[I, -skew(p - p_b)]; [0, I]]``; a revolute joint j on
    the support path ``[a_j x (p - p_j); a_j]``; prismatic ``[a_j; 0]``;
    other joints zero.
    """
    dtype, device = poses.rotation.dtype, poses.rotation.device
    c = tree_constants(tree, device, dtype)
    base_lin, base_ang = _base_rows(point_w - poses.position[..., 0, :], dtype, device)
    if not tree.num_dofs:
        return torch.cat([base_lin, base_ang], dim=-2)
    a, anchors = _joint_columns(tree, poses, c)                 # (..., n, 3)
    diff = point_w[..., None, :] - anchors
    crossed = torch.linalg.cross(a, diff, dim=-1)
    lin = torch.where(c.rev, crossed, a) * c.onpath[link_index]
    ang = a * c.onpath_rev[link_index]
    Jlin = torch.cat([base_lin, lin.transpose(-1, -2)], dim=-1)
    Jang = torch.cat([base_ang, ang.transpose(-1, -2)], dim=-1)
    return torch.cat([Jlin, Jang], dim=-2)


def _attached_point_jacobians(tree: KinematicTree, poses: LinkPoses, points):
    """Mixed Jacobians (..., L, 6, 6+n) of one world point per link,
    ``points`` (..., L, 3), point i rigidly attached to link i."""
    dtype, device = poses.rotation.dtype, poses.rotation.device
    c = tree_constants(tree, device, dtype)
    base_lin, base_ang = _base_rows(points - poses.position[..., :1, :], dtype, device)
    if not tree.num_dofs:
        return torch.cat([base_lin, base_ang], dim=-2)
    a, anchors = _joint_columns(tree, poses, c)                 # (..., n, 3)
    a = a[..., None, :, :]                                      # (..., 1, n, 3)
    diff = points[..., :, None, :] - anchors[..., None, :, :]   # (..., L, n, 3)
    crossed = torch.linalg.cross(a.expand(diff.shape), diff, dim=-1)
    lin = torch.where(c.rev, crossed, a) * c.onpath
    ang = a * c.onpath_rev
    Jlin = torch.cat([base_lin, lin.transpose(-1, -2)], dim=-1)
    Jang = torch.cat([base_ang, ang.transpose(-1, -2)], dim=-1)
    return torch.cat([Jlin, Jang], dim=-2)


def link_jacobians(tree: KinematicTree, poses: LinkPoses) -> torch.Tensor:
    """Mixed Jacobians of every link origin, stacked ``(..., L, 6, 6+n)``.

    Vectorized over links and joints: one (..., L, n, 3) cross product and two
    static masks.
    """
    return _attached_point_jacobians(tree, poses, poses.position)


def frame_pose(tree: KinematicTree, poses: LinkPoses, frame: str):
    """World (rotation, position) of a named frame."""
    c = tree_constants(tree, poses.rotation.device, poses.rotation.dtype)
    link, off_p, off_R = c.frames[frame]
    R_link = poses.rotation[..., link, :, :]
    return R_link @ off_R, poses.position[..., link, :] + R_link @ off_p


def frame_jacobian(tree: KinematicTree, poses: LinkPoses, frame: str) -> torch.Tensor:
    """Mixed free-floating Jacobian (..., 6, 6+n) of a named frame."""
    link = tree.frames[frame][0]
    _, p = frame_pose(tree, poses, frame)
    return point_jacobian_columns(tree, poses, link, p)
