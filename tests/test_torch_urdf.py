"""The port's URDF loader and serializer (``models/urdf.py``) against
``blf_tpu.models.urdf``.

Both packages parse the committed models (``blf_tpu/models/*.urdf``, read
as data files) to the same trees: the same names, parents, joint types and
frames, and axes, origins, masses, CoMs and inertias equal to the last bit
(the same numpy arithmetic on the same text). ``to_urdf`` writes the same
text on both sides and round-trips. The semantic and error cases of
``tests/test_urdf.py`` are run through both packages.
"""

import os

import numpy as np
import pytest
import torch

from blf_tpu.models import urdf as jurdf
from blf_tpu_torch.models import urdf as turdf
from blf_tpu_torch.models.kinematics import forward_kinematics, frame_pose
from blf_tpu_torch.models.robots import make_humanoid_23dof

torch.set_num_threads(1)

MODELS = os.path.join(os.path.dirname(__file__), "..", "blf_tpu", "models")
ARRAYS = ("axis", "joint_position", "joint_rotation", "mass", "com", "inertia")


def assert_same_tree(a, b, atol=0.0):
    """Two trees (of either package) describe the same robot."""
    assert tuple(a.link_names) == tuple(b.link_names)
    assert tuple(a.parent) == tuple(b.parent)
    assert tuple(a.joint_type) == tuple(b.joint_type)
    for name in ARRAYS:
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), rtol=0, atol=atol,
                                   err_msg=name)
    assert set(a.frames) == set(b.frames)
    for k in a.frames:
        (la, pa, Ra), (lb, pb, Rb) = a.frames[k], b.frames[k]
        assert la == lb
        np.testing.assert_allclose(pa, pb, rtol=0, atol=atol)
        np.testing.assert_allclose(Ra, Rb, rtol=0, atol=atol)


@pytest.mark.parametrize("model", ["humanoid_23dof.urdf", "icub_style.urdf"])
def test_committed_models_parse_alike_and_round_trip(model):
    path = os.path.join(MODELS, model)
    port, ref = turdf.load_urdf(path), jurdf.load_urdf(path)
    assert_same_tree(port, ref)
    assert port.num_dofs == 23
    assert turdf.to_urdf(port) == jurdf.to_urdf(ref)
    assert_same_tree(turdf.loads_urdf(turdf.to_urdf(port)), port, atol=1e-12)


def test_committed_humanoid_is_the_factory_model():
    """``test_committed_urdf_equals_factory`` and ``test_fk_matches_factory``
    with the port's own factory and kinematics."""
    tree = turdf.load_urdf(os.path.join(MODELS, "humanoid_23dof.urdf"))
    factory = make_humanoid_23dof()
    assert_same_tree(tree, factory, atol=1e-12)
    q = torch.as_tensor(np.random.default_rng(0).normal(0, 0.3, 23))
    base_p = torch.tensor([0.1, -0.2, 0.8], dtype=torch.float64)
    base_R = torch.eye(3, dtype=torch.float64)
    pu = forward_kinematics(tree, base_p, base_R, q)
    pf = forward_kinematics(factory, base_p, base_R, q)
    np.testing.assert_allclose(pu.position.numpy(), pf.position.numpy(), atol=1e-12)
    np.testing.assert_allclose(pu.rotation.numpy(), pf.rotation.numpy(), atol=1e-12)
    _, sole = frame_pose(tree, pu, "l_sole")
    assert sole.shape == (3,)


INERTIAL = '<inertial><mass value="1"/><inertia ixx="1" iyy="1" izz="1"/></inertial>'
SEMANTICS = {
    "rpy_fixed_axis_xyz": f"""<robot name="r"><link name="base">{INERTIAL}</link>
        <link name="child">{INERTIAL}</link>
        <joint name="j" type="revolute"><origin xyz="0.1 0.2 0.3" rpy="0.3 -0.4 0.5"/>
        <parent link="base"/><child link="child"/><axis xyz="0 0 1"/></joint></robot>""",
    "inertia_rotated": """<robot name="r"><link name="base"><inertial>
        <origin xyz="0 0 0" rpy="0 0 1.5707963267948966"/><mass value="2"/>
        <inertia ixx="1" iyy="4" izz="9"/></inertial></link></robot>""",
    "massless_leaf_is_a_frame": f"""<robot name="r"><link name="base">{INERTIAL}</link>
        <link name="sole"/><joint name="j" type="fixed"><origin xyz="0 0 -0.05"/>
        <parent link="base"/><child link="sole"/></joint></robot>""",
    "massy_fixed_link_stays": f"""<robot name="r"><link name="base">{INERTIAL}</link>
        <link name="battery"><inertial><mass value="0.5"/>
        <inertia ixx="1e-3" iyy="1e-3" izz="1e-3"/></inertial></link>
        <joint name="j" type="fixed"><parent link="base"/><child link="battery"/></joint>
        </robot>""",
    "prismatic_and_continuous": f"""<robot name="r"><link name="base">{INERTIAL}</link>
        <link name="slider">{INERTIAL}</link><link name="wheel">{INERTIAL}</link>
        <joint name="a" type="prismatic"><parent link="base"/><child link="slider"/>
        <axis xyz="1 0 0"/></joint>
        <joint name="b" type="continuous"><parent link="slider"/><child link="wheel"/>
        <axis xyz="0 1 0"/></joint></robot>""",
    "axis_normalized": f"""<robot name="r"><link name="base">{INERTIAL}</link>
        <link name="c">{INERTIAL}</link><joint name="j" type="revolute">
        <parent link="base"/><child link="c"/><axis xyz="0 0 2"/></joint></robot>""",
}


@pytest.mark.parametrize("case", sorted(SEMANTICS))
def test_semantics_match_the_reference(case):
    port, ref = turdf.loads_urdf(SEMANTICS[case]), jurdf.loads_urdf(SEMANTICS[case])
    assert_same_tree(port, ref)
    assert port.num_dofs == ref.num_dofs and port.num_links == ref.num_links


BASE = '<robot name="r"><link name="a"/><link name="b"/><link name="c"/>{}</robot>'
ERRORS = {
    "exactly one root": '<joint name="j" type="fixed"><parent link="a"/><child link="b"/></joint>',
    "two parent joints": ('<joint name="j1" type="fixed"><parent link="a"/><child link="c"/>'
                          '</joint><joint name="j2" type="fixed"><parent link="b"/>'
                          '<child link="c"/></joint>'),
    "unsupported joint type": ('<joint name="j1" type="floating"><parent link="a"/>'
                               '<child link="b"/></joint>'),
    "unknown": '<joint name="j1" type="fixed"><parent link="a"/><child link="zzz"/></joint>',
}


@pytest.mark.parametrize("match", sorted(ERRORS))
def test_malformed_documents_raise_alike(match):
    text = BASE.format(ERRORS[match])
    with pytest.raises(ValueError, match=match) as port_error:
        turdf.loads_urdf(text)
    with pytest.raises(ValueError) as ref_error:
        jurdf.loads_urdf(text)
    assert str(port_error.value) == str(ref_error.value)
