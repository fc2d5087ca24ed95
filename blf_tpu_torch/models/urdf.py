"""URDF-lite: load/serialize :class:`KinematicTree` from/to URDF XML.

Counterpart of ``blf_tpu/models/urdf.py``; everything of it is ported, as
host-side numpy and ``xml.etree`` onto the port's own
:class:`blf_tpu_torch.models.kinematics.KinematicTree` and its builder. The
committed models ``blf_tpu/models/humanoid_23dof.urdf`` and
``icub_style.urdf`` are data files: :func:`load_urdf` reads them by path.

Supported subset (enough for rigid humanoids):

- ``<link>`` with ``<inertial>`` (``origin xyz/rpy``, ``mass``,
  ``inertia ixx..izz``); visual/collision elements are ignored.
- ``<joint>`` of type ``revolute``/``continuous``/``prismatic``/``fixed``
  with ``<origin xyz rpy>``, ``<axis xyz>``, ``<parent>``/``<child>``.
  Limits/dynamics/mimic are ignored (the MPC layer owns limits).
- The root link becomes the floating base. A **fixed, massless leaf** link
  becomes a named *frame* on its parent (the usual idiom for sole and
  sensor frames), not a tree link.

URDF conventions honoured: ``rpy`` is the fixed-axis XYZ convention
(``R = Rz(yaw) Ry(pitch) Rx(roll)``); the child-link frame coincides with
the joint frame; the ``<inertial>`` tensor is about the inertial origin in
the inertial frame and is rotated into the link frame on load (the tree
stores inertia about the CoM in link axes).
"""

from __future__ import annotations

import io
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

from blf_tpu_torch.models.kinematics import (
    FIXED,
    PRISMATIC,
    REVOLUTE,
    KinematicTree,
    KinematicTreeBuilder,
)

__all__ = ["load_urdf", "loads_urdf", "to_urdf"]

_JOINT_TYPES = {
    "revolute": REVOLUTE,
    "continuous": REVOLUTE,
    "prismatic": PRISMATIC,
    "fixed": FIXED,
}
_TYPE_NAMES = {REVOLUTE: "revolute", PRISMATIC: "prismatic", FIXED: "fixed"}


def _vec(attr: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if not attr:
        return np.asarray(default, dtype=float)
    return np.asarray([float(x) for x in attr.split()], dtype=float)


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis XYZ: R = Rz(yaw) · Ry(pitch) · Rx(roll)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _matrix_to_rpy(R: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_rpy_to_matrix` (gimbal branch |pitch| < π/2)."""
    p = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    r = np.arctan2(R[2, 1], R[2, 2])
    y = np.arctan2(R[1, 0], R[0, 0])
    return np.array([r, p, y])


def _parse_inertial(link: ET.Element):
    """(mass, com_xyz, inertia_about_com_in_link_axes) for one link."""
    inertial = link.find("inertial")
    if inertial is None:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    origin = inertial.find("origin")
    com = _vec(origin.get("xyz") if origin is not None else None)
    R_i = _rpy_to_matrix(_vec(origin.get("rpy") if origin is not None else None))
    mass_el = inertial.find("mass")
    mass = float(mass_el.get("value")) if mass_el is not None else 0.0
    inertia_el = inertial.find("inertia")
    if inertia_el is not None:
        g = lambda k: float(inertia_el.get(k, "0"))
        I = np.array([
            [g("ixx"), g("ixy"), g("ixz")],
            [g("ixy"), g("iyy"), g("iyz")],
            [g("ixz"), g("iyz"), g("izz")],
        ])
    else:
        I = np.zeros((3, 3))
    return mass, com, R_i @ I @ R_i.T


def loads_urdf(text: str) -> KinematicTree:
    """Parse a URDF document (string) into a :class:`KinematicTree`."""
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError(f"not a URDF document (root tag {root.tag!r})")

    links: Dict[str, ET.Element] = {}
    for el in root.findall("link"):
        name = el.get("name")
        if name is None:
            raise ValueError("link without a name")
        if name in links:
            raise ValueError(f"duplicate link {name!r}")
        links[name] = el

    joints: List[dict] = []
    child_joint: Dict[str, dict] = {}
    children: Dict[str, List[str]] = {name: [] for name in links}
    for el in root.findall("joint"):
        jtype = el.get("type")
        if jtype not in _JOINT_TYPES:
            raise ValueError(f"unsupported joint type {jtype!r} "
                             f"(joint {el.get('name')!r})")
        parent_el, child_el = el.find("parent"), el.find("child")
        if parent_el is None or child_el is None:
            raise ValueError(f"joint {el.get('name')!r} missing parent/child")
        parent, child = parent_el.get("link"), child_el.get("link")
        if parent not in links or child not in links:
            raise ValueError(f"joint {el.get('name')!r} references unknown "
                             f"links {parent!r}/{child!r}")
        if child in child_joint:
            raise ValueError(f"link {child!r} has two parent joints "
                             "(URDF must be a tree)")
        origin = el.find("origin")
        axis_el = el.find("axis")
        j = dict(
            name=el.get("name"),
            type=_JOINT_TYPES[jtype],
            parent=parent,
            child=child,
            xyz=_vec(origin.get("xyz") if origin is not None else None),
            rpy=_vec(origin.get("rpy") if origin is not None else None),
            axis=_vec(axis_el.get("xyz") if axis_el is not None else None,
                      default=(1.0, 0.0, 0.0)),
        )
        joints.append(j)
        child_joint[child] = j
        children[parent].append(child)

    roots = [name for name in links if name not in child_joint]
    if len(roots) != 1:
        raise ValueError(f"expected exactly one root link, found {roots}")
    base = roots[0]

    mass, com, inertia = _parse_inertial(links[base])
    b = KinematicTreeBuilder(base_name=base, base_mass=mass, base_com=com,
                             base_inertia=inertia)

    def is_frame(name: str) -> bool:
        # fixed, massless leaf ⇒ attachment frame, not a tree link
        j = child_joint[name]
        if j["type"] != FIXED or children[name]:
            return False
        m, _, _ = _parse_inertial(links[name])
        return m == 0.0

    def visit(name: str) -> None:
        for child in children[name]:
            j = child_joint[child]
            if is_frame(child):
                b.add_frame(child, name, position=j["xyz"],
                            rotation=_rpy_to_matrix(j["rpy"]))
                continue
            m, c, I = _parse_inertial(links[child])
            b.add_link(
                child, name,
                joint_type=j["type"],
                axis=j["axis"] if j["type"] != FIXED else (0.0, 0.0, 1.0),
                joint_position=j["xyz"],
                joint_rotation=_rpy_to_matrix(j["rpy"]),
                mass=m, com=c, inertia=I,
            )
            visit(child)

    visit(base)
    return b.finalize()


def load_urdf(path: str | os.PathLike) -> KinematicTree:
    """Load a URDF file into a :class:`KinematicTree`."""
    with open(path, "r", encoding="utf-8") as fh:
        return loads_urdf(fh.read())


def _fmt(v: np.ndarray) -> str:
    return " ".join(repr(float(x)) for x in np.asarray(v).reshape(-1))


def to_urdf(tree: KinematicTree, robot_name: str = "robot") -> str:
    """Serialize a :class:`KinematicTree` to URDF XML.

    Inverse of :func:`loads_urdf` on the supported subset: loading the
    output reproduces the tree bit-for-bit except joint/frame rotations,
    which round-trip through rpy (exact to f64 trigonometry; the round-trip
    test pins 1e-12). Frames are emitted as fixed massless child links.
    """
    out = io.StringIO()
    out.write(f'<robot name="{robot_name}">\n')
    for i, name in enumerate(tree.link_names):
        out.write(f'  <link name="{name}">\n')
        out.write('    <inertial>\n')
        out.write(f'      <origin xyz="{_fmt(tree.com[i])}" rpy="0 0 0"/>\n')
        out.write(f'      <mass value="{float(tree.mass[i])!r}"/>\n')
        I = tree.inertia[i].astype(float)
        out.write(f'      <inertia ixx="{float(I[0, 0])!r}" '
                  f'ixy="{float(I[0, 1])!r}" ixz="{float(I[0, 2])!r}" '
                  f'iyy="{float(I[1, 1])!r}" iyz="{float(I[1, 2])!r}" '
                  f'izz="{float(I[2, 2])!r}"/>\n')
        out.write('    </inertial>\n')
        out.write('  </link>\n')
        if i == 0:
            continue
        parent = tree.link_names[tree.parent[i]]
        tname = _TYPE_NAMES[tree.joint_type[i]]
        out.write(f'  <joint name="{parent}_to_{name}" type="{tname}">\n')
        out.write(f'    <origin xyz="{_fmt(tree.joint_position[i])}" '
                  f'rpy="{_fmt(_matrix_to_rpy(tree.joint_rotation[i]))}"/>\n')
        out.write(f'    <parent link="{parent}"/>\n')
        out.write(f'    <child link="{name}"/>\n')
        if tree.joint_type[i] != FIXED:
            out.write(f'    <axis xyz="{_fmt(tree.axis[i])}"/>\n')
        out.write('  </joint>\n')
    for fname, (link, off_p, off_R) in tree.frames.items():
        parent = tree.link_names[link]
        out.write(f'  <link name="{fname}"/>\n')
        out.write(f'  <joint name="{parent}_to_{fname}" type="fixed">\n')
        out.write(f'    <origin xyz="{_fmt(off_p)}" '
                  f'rpy="{_fmt(_matrix_to_rpy(off_R))}"/>\n')
        out.write(f'    <parent link="{parent}"/>\n')
        out.write(f'    <child link="{fname}"/>\n')
        out.write('  </joint>\n')
    out.write('</robot>\n')
    return out.getvalue()
