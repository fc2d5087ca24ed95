"""Robot model zoo: a 23-DoF humanoid for benchmarks and tests.

Counterpart of ``blf_tpu/models/robots.py``: the port's own copy (host-side
numpy code, same numbers), built on :mod:`blf_tpu_torch.models.kinematics`,
so that the whole-body controller's humanoid is self-contained and
deterministic. Proportions and inertias are
plausible for a ~30 kg, 1.1 m child-size humanoid (iCub-class); they are NOT
a calibration of any specific robot.

Topology (23 DoF): 2 × 6-DoF legs, 3-DoF torso, 2 × 4-DoF arms.
"""

from __future__ import annotations

import numpy as np

from blf_tpu_torch.models.kinematics import KinematicTree, KinematicTreeBuilder

__all__ = ["make_humanoid_23dof", "HUMANOID_SOLE_FRAMES"]

HUMANOID_SOLE_FRAMES = ("l_sole", "r_sole")


def _box_inertia(mass, lx, ly, lz):
    return mass / 12.0 * np.diag(
        [ly * ly + lz * lz, lx * lx + lz * lz, lx * lx + ly * ly]
    )


def make_humanoid_23dof() -> KinematicTree:
    """Floating-base humanoid: pelvis base, legs (hip 3 + knee 1 + ankle 2),
    torso (3), arms (shoulder 3 + elbow 1)."""
    b = KinematicTreeBuilder(
        base_name="pelvis", base_mass=6.0, base_com=(0.0, 0.0, 0.05),
        base_inertia=_box_inertia(6.0, 0.12, 0.20, 0.12),
    )

    for side, sgn in (("l", 1.0), ("r", -1.0)):
        hip = (0.0, sgn * 0.08, -0.05)
        b.add_link(f"{side}_hip_1", "pelvis", axis=(0, 0, 1),
                   joint_position=hip, mass=0.8, com=(0, 0, -0.02),
                   inertia=_box_inertia(0.8, 0.08, 0.08, 0.06))
        b.add_link(f"{side}_hip_2", f"{side}_hip_1", axis=(1, 0, 0),
                   mass=0.8, com=(0, 0, -0.02),
                   inertia=_box_inertia(0.8, 0.08, 0.08, 0.06))
        b.add_link(f"{side}_upper_leg", f"{side}_hip_2", axis=(0, 1, 0),
                   mass=2.5, com=(0, 0, -0.13),
                   inertia=_box_inertia(2.5, 0.09, 0.09, 0.26))
        b.add_link(f"{side}_lower_leg", f"{side}_upper_leg", axis=(0, 1, 0),
                   joint_position=(0, 0, -0.26), mass=1.8, com=(0, 0, -0.12),
                   inertia=_box_inertia(1.8, 0.07, 0.07, 0.24))
        b.add_link(f"{side}_ankle_1", f"{side}_lower_leg", axis=(0, 1, 0),
                   joint_position=(0, 0, -0.24), mass=0.5, com=(0, 0, -0.02),
                   inertia=_box_inertia(0.5, 0.06, 0.06, 0.04))
        b.add_link(f"{side}_foot", f"{side}_ankle_1", axis=(1, 0, 0),
                   mass=0.6, com=(0.03, 0, -0.03),
                   inertia=_box_inertia(0.6, 0.14, 0.07, 0.04))
        b.add_frame(f"{side}_sole", f"{side}_foot", position=(0.03, 0.0, -0.05))

    b.add_link("torso_1", "pelvis", axis=(0, 0, 1),
               joint_position=(0, 0, 0.1), mass=1.0, com=(0, 0, 0.03),
               inertia=_box_inertia(1.0, 0.10, 0.15, 0.08))
    b.add_link("torso_2", "torso_1", axis=(1, 0, 0),
               mass=1.0, com=(0, 0, 0.03),
               inertia=_box_inertia(1.0, 0.10, 0.15, 0.08))
    b.add_link("chest", "torso_2", axis=(0, 1, 0),
               mass=5.5, com=(0, 0, 0.10),
               inertia=_box_inertia(5.5, 0.14, 0.22, 0.24))
    b.add_frame("imu", "chest", position=(0.0, 0.0, 0.15))

    for side, sgn in (("l", 1.0), ("r", -1.0)):
        sh = (0.0, sgn * 0.14, 0.18)
        b.add_link(f"{side}_shoulder_1", "chest", axis=(0, 1, 0),
                   joint_position=sh, mass=0.6, com=(0, sgn * 0.02, 0),
                   inertia=_box_inertia(0.6, 0.06, 0.06, 0.06))
        b.add_link(f"{side}_shoulder_2", f"{side}_shoulder_1", axis=(1, 0, 0),
                   mass=0.6, com=(0, 0, -0.02),
                   inertia=_box_inertia(0.6, 0.06, 0.06, 0.06))
        b.add_link(f"{side}_upper_arm", f"{side}_shoulder_2", axis=(0, 0, 1),
                   mass=1.2, com=(0, 0, -0.09),
                   inertia=_box_inertia(1.2, 0.06, 0.06, 0.18))
        b.add_link(f"{side}_forearm", f"{side}_upper_arm", axis=(0, 1, 0),
                   joint_position=(0, 0, -0.18), mass=0.9, com=(0, 0, -0.08),
                   inertia=_box_inertia(0.9, 0.05, 0.05, 0.16))
        b.add_frame(f"{side}_hand", f"{side}_forearm", position=(0, 0, -0.16))

    tree = b.finalize()
    if tree.num_dofs != 23:
        raise RuntimeError(f"humanoid has {tree.num_dofs} DoFs, expected 23")
    return tree
