"""The port's kinematics and rigid-body engine against ``blf_tpu``'s.

Float64 on both sides, the 23-DoF humanoid, four random states drawn with
seeded numpy and handed to both. Tolerance 1e-9 (absolute and relative): the
two sides run the same formulas with other summation orders (the port forms
all joint transforms and all CoM-point Jacobians at once), so they agree to
rounding, and the largest entries (bias forces, ~1e2) carry ~1e-13 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models import kinematics as jkin
from blf_tpu.models import rigid_body as jrb
from blf_tpu.models.robots import make_humanoid_23dof as jax_humanoid
from blf_tpu_torch.models import kinematics as tkin
from blf_tpu_torch.models import rigid_body as trb
from blf_tpu_torch.models.robots import HUMANOID_SOLE_FRAMES, make_humanoid_23dof
from blf_tpu_torch.ops.lie import so3_exp
from test_torch_wbc_loop import in_background, reference_jit

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-9)
JTREE = jax_humanoid()
TTREE = make_humanoid_23dof()
N = TTREE.num_dofs
FRAMES = HUMANOID_SOLE_FRAMES + ("imu",)
B = 4


def random_states(seed=0):
    rng = np.random.default_rng(seed)
    rotvec = rng.normal(0, 0.4, (B, 3))
    R = so3_exp(torch.as_tensor(rotvec)).numpy()
    return dict(
        base_position=rng.normal(0, 0.3, (B, 3)),
        base_rotation=R,
        joint_positions=rng.uniform(-0.6, 0.6, (B, N)),
        base_twist=rng.normal(0, 0.5, (B, 6)),
        joint_velocities=rng.normal(0, 1.0, (B, N)),
        torques=rng.normal(0, 5.0, (B, N)),
        wrench_l=rng.normal(0, 20.0, (B, 6)),
        wrench_r=rng.normal(0, 20.0, (B, 6)),
        minv_noise=rng.normal(0, 1e-3, (B, 6 + N, 6 + N)),
    )


def jax_everything(s):
    """Every compared quantity of one state, as a dict (single sample)."""
    bp, bR, q = s["base_position"], s["base_rotation"], s["joint_positions"]
    tw, qd = s["base_twist"], s["joint_velocities"]
    nu = jnp.concatenate([tw, qd])
    poses = jkin.forward_kinematics(JTREE, bp, bR, q)
    out = {"fk_position": poses.position, "fk_rotation": poses.rotation,
           "link_jacobians": jkin.link_jacobians(JTREE, poses),
           "spatial_inertias": jrb.spatial_inertias(JTREE, poses),
           "mass_matrix": jrb.mass_matrix(JTREE, bp, bR, q),
           "bias_forces": jrb.bias_forces(JTREE, bp, bR, q, tw, qd),
           "generalized_gravity": jrb.generalized_gravity(JTREE, bp, bR, q),
           "total_momentum": jrb.total_momentum(JTREE, bp, bR, q, nu),
           "kinetic_energy": jrb.kinetic_energy(JTREE, bp, bR, q, nu),
           "com_position": jrb.com_position(JTREE, poses),
           "com_jacobian": jrb.com_jacobian(JTREE, poses),
           "com_velocity": jrb.com_velocity(JTREE, poses, nu),
           "com_bias_acceleration": jrb.com_bias_acceleration(JTREE, bp, bR, q, tw, qd)}
    for f in FRAMES:
        R, p = jkin.frame_pose(JTREE, poses, f)
        out[f"frame_rotation_{f}"], out[f"frame_position_{f}"] = R, p
        out[f"frame_jacobian_{f}"] = jkin.frame_jacobian(JTREE, poses, f)
        out[f"frame_velocity_{f}"] = jrb.frame_velocity(JTREE, poses, f, nu)
        out[f"frame_bias_acceleration_{f}"] = jrb.frame_bias_acceleration(
            JTREE, bp, bR, q, tw, qd, f)
    state = jrb.FloatingBaseState(tw, qd, bp, bR, q)
    inp = jrb.FloatingBaseInput(s["torques"], {"l_sole": s["wrench_l"],
                                               "r_sole": s["wrench_r"]})
    for name, kw in (("dyn", {}), ("dyn_minv", {"minv": True})):
        if kw:
            M = out["mass_matrix"]
            kw = {"minv": jnp.linalg.inv(M) + s["minv_noise"]}
        d = jrb.floating_base_dynamics(JTREE, state, inp, rho=1.0, **kw)
        for field, val in d._asdict().items():
            out[f"{name}_{field}"] = val
    return out


def torch_everything(s):
    """The same quantities from the port, batch-explicit (any leading axes)."""
    bp, bR, q = s["base_position"], s["base_rotation"], s["joint_positions"]
    tw, qd = s["base_twist"], s["joint_velocities"]
    nu = torch.cat([tw, qd], dim=-1)
    poses = tkin.forward_kinematics(TTREE, bp, bR, q)
    out = {"fk_position": poses.position, "fk_rotation": poses.rotation,
           "link_jacobians": tkin.link_jacobians(TTREE, poses),
           "spatial_inertias": trb.spatial_inertias(TTREE, poses),
           "mass_matrix": trb.mass_matrix(TTREE, bp, bR, q),
           "bias_forces": trb.bias_forces(TTREE, bp, bR, q, tw, qd),
           "generalized_gravity": trb.generalized_gravity(TTREE, bp, bR, q),
           "total_momentum": trb.total_momentum(TTREE, bp, bR, q, nu),
           "kinetic_energy": trb.kinetic_energy(TTREE, bp, bR, q, nu),
           "com_position": trb.com_position(TTREE, poses),
           "com_jacobian": trb.com_jacobian(TTREE, poses),
           "com_velocity": trb.com_velocity(TTREE, poses, nu),
           "com_bias_acceleration": trb.com_bias_acceleration(TTREE, bp, bR, q, tw, qd)}
    for f in FRAMES:
        R, p, v = trb.frame_kinematics(TTREE, poses, f, nu)
        out[f"frame_rotation_{f}"], out[f"frame_position_{f}"] = R, p
        out[f"frame_jacobian_{f}"] = tkin.frame_jacobian(TTREE, poses, f)
        out[f"frame_velocity_{f}"] = v
        out[f"frame_bias_acceleration_{f}"] = trb.frame_bias_acceleration(
            TTREE, bp, bR, q, tw, qd, f)
    state = trb.FloatingBaseState(tw, qd, bp, bR, q)
    inp = trb.FloatingBaseInput(s["torques"], {"l_sole": s["wrench_l"],
                                               "r_sole": s["wrench_r"]})
    for name, kw in (("dyn", {}), ("dyn_minv", {"minv": True})):
        if kw:
            kw = {"minv": torch.linalg.inv(out["mass_matrix"]) + s["minv_noise"]}
        d = trb.floating_base_dynamics(TTREE, state, inp, rho=1.0, **kw)
        for field, val in d._asdict().items():
            out[f"{name}_{field}"] = val
    return out


@pytest.fixture(scope="module")
def both():
    s = random_states()
    args = {k: jnp.asarray(v) for k, v in s.items()}
    # traced here, compiled on a thread while the port computes its side
    compiled = in_background(reference_jit(jax.vmap(jax_everything)).lower(args).compile)
    st = {k: torch.as_tensor(v) for k, v in s.items()}
    with torch.no_grad():
        got = torch_everything(st)
        solo = [torch_everything({k: v[i] for k, v in st.items()}) for i in range(B)]
    ref = {k: np.asarray(v) for k, v in compiled()(args).items()}
    return ref, got, solo


KEYS = sorted(
    ["fk_position", "fk_rotation", "link_jacobians", "spatial_inertias",
     "mass_matrix", "bias_forces", "generalized_gravity", "total_momentum",
     "kinetic_energy", "com_position", "com_jacobian", "com_velocity",
     "com_bias_acceleration"]
    + [f"frame_{what}_{f}" for f in FRAMES
       for what in ("rotation", "position", "jacobian", "velocity",
                    "bias_acceleration")]
    + [f"{name}_{field}" for name in ("dyn", "dyn_minv")
       for field in trb.FloatingBaseState._fields])


def test_every_compared_quantity_is_listed(both):
    ref, got, _ = both
    assert sorted(ref) == sorted(got) == KEYS


@pytest.mark.parametrize("key", KEYS)
def test_matches_the_reference(both, key):
    ref, got, _ = both
    assert got[key].dtype == torch.float64
    assert tuple(got[key].shape) == ref[key].shape
    np.testing.assert_allclose(got[key].numpy(), ref[key], **TOL)


@pytest.mark.parametrize("key", ["fk_rotation", "link_jacobians", "mass_matrix",
                                 "bias_forces", "com_jacobian",
                                 "frame_bias_acceleration_l_sole",
                                 "dyn_base_twist", "dyn_joint_velocities",
                                 "dyn_minv_joint_velocities"])
def test_batch_of_four_equals_four_single_calls(both, key):
    """The batch is only leading dimensions: 1e-12, the difference being the
    blocking of batched matrix products."""
    _, got, solo = both
    for i in range(B):
        assert solo[i][key].shape == got[key].shape[1:]
        np.testing.assert_allclose(solo[i][key].numpy(), got[key][i].numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_two_leading_batch_axes_and_float32():
    s = {k: torch.as_tensor(v).reshape((2, 2) + v.shape[1:]).float()
         for k, v in random_states().items()}
    out = torch_everything(s)
    assert out["mass_matrix"].shape == (2, 2, 6 + N, 6 + N)
    assert all(v.dtype == torch.float32 for v in out.values())
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_tree_constants_are_made_once_per_device_and_dtype():
    a = tkin.tree_constants(TTREE, "cpu", torch.float64)
    assert tkin.tree_constants(TTREE, torch.device("cpu"), torch.float64) is a
    assert tkin.tree_constants(TTREE, "cpu", torch.float32) is not a
    assert TTREE.ancestor_mask is TTREE.ancestor_mask      # cached, not recomputed
    np.testing.assert_array_equal(TTREE.ancestor_mask, JTREE.ancestor_mask)
    assert TTREE.dof_index == JTREE.dof_index and TTREE.nv == JTREE.nv == 29
    for name in ("axis", "joint_position", "mass", "com", "inertia"):
        np.testing.assert_array_equal(getattr(TTREE, name), getattr(JTREE, name))


def test_a_matrix_that_is_not_positive_definite_gives_nan_in_its_lane_only():
    rng = np.random.default_rng(1)
    G = rng.normal(size=(3, 5, 5))
    M = torch.as_tensor(G @ G.transpose(0, 2, 1) + 5 * np.eye(5))
    M[1, 2, 2] = -1.0
    from blf_tpu_torch.ops.linalg import cholesky_nan

    L = cholesky_nan(M)
    assert bool(torch.isnan(L[1]).all())
    np.testing.assert_allclose(L[0].numpy(), np.linalg.cholesky(M[0].numpy()), rtol=1e-12)
    np.testing.assert_allclose(L[2].numpy(), np.linalg.cholesky(M[2].numpy()), rtol=1e-12)


def test_contact_dynamics_wait_for_the_contact_model():
    """The contact model is ported (``tests/test_torch_contact.py`` holds the
    closed loop to the reference on a biped): with no contact frame the
    closed-loop dynamics are the engine's own under zero torques."""
    rng = np.random.default_rng(9)
    n = TTREE.num_dofs
    f64 = dict(dtype=torch.float64)
    state = trb.FloatingBaseState(
        torch.as_tensor(rng.normal(0, 0.1, (2, 6))), torch.as_tensor(rng.normal(0, 0.1, (2, n))),
        torch.zeros(2, 3, **f64), torch.eye(3, **f64).repeat(2, 1, 1),
        torch.as_tensor(rng.uniform(-0.2, 0.2, (2, n))))
    closed = trb.make_contact_dynamics(TTREE, {}, rho=1.0)(state, {})
    plain = trb.floating_base_dynamics(
        TTREE, state, trb.FloatingBaseInput(torch.zeros(2, n, **f64), {}), rho=1.0)
    for a, b in zip(closed, plain):
        assert torch.equal(a, b)
