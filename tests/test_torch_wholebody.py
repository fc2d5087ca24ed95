"""The port's whole-body QP, and slice 2a as a whole, against ``blf_tpu``.

Float64, the 23-DoF humanoid on two soles (QP of n = 64 unknowns, m = 86
rows), states and tasks drawn with seeded numpy and handed to both sides as
numpy arrays. The JAX side is jitted once per module.

- ``build_wholebody_qp``: P, q, A, l, u within 1e-9 (the rigid-body terms
  agree to rounding, ``tests/test_torch_rigid_body.py``; the largest entries,
  w_com J'J ~ 1e2 and the bias forces, carry ~1e-13 of it).
- ``solve_wholebody_qp`` on both backends, one cold solve each.

The slice as a whole, the closed loop, is held in
``tests/test_torch_wholebody_loop.py`` (this robot, ``backend="torch"``) and
``tests/test_torch_wbc_loop.py`` (a small biped, ``backend="cuda"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models import rigid_body as jrb
from blf_tpu.models.robots import make_humanoid_23dof as jax_humanoid
from blf_tpu.mpc import wholebody as jwb
from blf_tpu_torch.convert import (floating_base_state_from_numpy,
                                   floating_base_state_to_numpy,
                                   wholebody_task_from_numpy)
from blf_tpu_torch.mpc import wholebody as twb
from blf_tpu_torch.ops.lie import so3_exp
from test_torch_wbc_loop import reference_jit
from blf_tpu_torch.problems import standing_fleet

# One intra-op thread: the tensors here are a few lanes wide, so more threads
# gain nothing, and test workers running side by side would each start a
# thread per core and slow every other worker down.
torch.set_num_threads(1)

JTREE = jax_humanoid()
B = 4


@pytest.fixture(scope="module")
def fleet():
    return standing_fleet(B, seed=0, device="cpu", dtype=torch.float64)


def jparams(fleet):
    return jwb.WholeBodyParams(**fleet.params._asdict())


def moving_states(fleet, seed=1):
    """The standing fleet pushed off rest: random twists, joint rates, tilts."""
    rng = np.random.default_rng(seed)
    s = floating_base_state_to_numpy(fleet.state)
    s["base_twist"] = rng.normal(0, 0.2, (B, 6))
    s["joint_velocities"] = rng.normal(0, 0.5, (B, 23))
    s["base_rotation"] = so3_exp(torch.as_tensor(rng.normal(0, 0.05, (B, 3)))).numpy()
    task = dict(com_acc_des=rng.normal(0, 0.3, (B, 3)),
                base_ang_acc_des=rng.normal(0, 0.3, (B, 3)),
                posture_acc_des=rng.normal(0, 1.0, (B, 23)),
                contact_active=np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
                ext_wrench=rng.normal(0, 5.0, (B, 1, 6)))
    return s, task


def jax_state(s):
    return jrb.FloatingBaseState(**{k: jnp.asarray(v) for k, v in s.items()})


def jax_task(t):
    return jwb.WholeBodyTask(**{k: jnp.asarray(v) for k, v in t.items()})


def test_build_wholebody_qp_matches_the_reference(fleet):
    """Mixed contact schedule (both feet, either foot) and an external wrench
    at the IMU frame: every block of the transcription is exercised."""
    ext_frames = ("imu",)
    s, task = moving_states(fleet)
    build = reference_jit(jax.vmap(lambda st, tk: jwb.build_wholebody_qp(
        JTREE, jparams(fleet), st, tk, ext_frames)))
    ref = build(jax_state(s), jax_task(task))
    out = twb.build_wholebody_qp(
        fleet.tree, fleet.params,
        floating_base_state_from_numpy(s, device="cpu", dtype=torch.float64),
        wholebody_task_from_numpy(task, device="cpu", dtype=torch.float64), ext_frames)
    for name, o, r in zip(("P", "q", "A", "l", "u"), out, ref):
        r = np.asarray(r)
        assert tuple(o.shape) == r.shape, name
        np.testing.assert_array_equal(np.isinf(o.numpy()), np.isinf(r), err_msg=name)
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-9, atol=1e-9, err_msg=name)
    assert tuple(out[0].shape) == (B, 64, 64) and tuple(out[2].shape) == (B, 86, 64)
    assert np.isneginf(out[3].numpy()[:, 41:63]).all()
    handler = twb.make_variables(fleet.tree, 2)
    assert handler.num_variables == 64 and handler.get_variable("tau").offset == 41


def test_build_works_unbatched_and_with_a_shared_task(fleet):
    s, task = moving_states(fleet)
    st = floating_base_state_from_numpy(s, device="cpu", dtype=torch.float64)
    tk = wholebody_task_from_numpy(task, device="cpu", dtype=torch.float64)
    batched = twb.build_wholebody_qp(fleet.tree, fleet.params, st, tk)
    pick = lambda nt, i: type(nt)(*(None if v is None else v[i] for v in nt))
    one = twb.build_wholebody_qp(fleet.tree, fleet.params, pick(st, 2), pick(tk, 2))
    for o, b in zip(one, batched):
        np.testing.assert_allclose(o.numpy(), b[2].numpy(), rtol=1e-12, atol=1e-12)
    shared = twb.build_wholebody_qp(fleet.tree, fleet.params, st, pick(tk, 0))
    np.testing.assert_allclose(shared[1][0].numpy(), batched[1][0].numpy(), atol=1e-12)


def test_solve_wholebody_qp_both_backends(fleet):
    """One cold solve from the moving states on each backend. They are two
    algorithms for one QP (alpha-relaxed x-z-y with refinement; v-space with
    the sigma x term dropped and a x5 hysteresis on the penalty), and cold the
    v-space one is the slower: after 1500 iterations both hold eps = 1e-4 and
    agree to 0.1 on accelerations (up to 28 rad/s^2), 0.05 on torques (limit
    60 N m) and 0.5 N on the total vertical force (334 N). How the load is shared between the feet
    is held only by the 1e-4 regulariser and is not compared. The v-space
    path's dual residual floors near 2e-3 absolute even in float64, as the
    reference's does (ROADMAP.md 2.4)."""
    s, task = moving_states(fleet)
    task["contact_active"] = np.ones((B, 2))
    st = floating_base_state_from_numpy(s, device="cpu", dtype=torch.float64)
    tk = wholebody_task_from_numpy(task, device="cpu", dtype=torch.float64)
    kw = dict(iterations=1500, ext_frames=("imu",), eps_abs=1e-4, eps_rel=1e-4)
    a = twb.solve_wholebody_qp(fleet.tree, fleet.params, st, tk, **kw)
    b = twb.solve_wholebody_qp(fleet.tree, fleet.params, st, tk, backend="cuda", **kw)
    assert tuple(a.wrenches.shape) == (B, 2, 6) and tuple(a.nu_dot.shape) == (B, 29)
    assert a.qp.refined is None and not bool(b.qp.refined)
    assert bool(a.qp.converged.all()) and bool(b.qp.converged.all())
    np.testing.assert_allclose(a.torques.numpy(), b.torques.numpy(), atol=0.05)
    np.testing.assert_allclose(a.nu_dot.numpy(), b.nu_dot.numpy(), atol=0.1)
    np.testing.assert_allclose(a.wrenches[..., 2].sum(-1).numpy(),
                               b.wrenches[..., 2].sum(-1).numpy(), atol=0.5)
    # the returned (nudot, f, tau) satisfy M nudot + h = S tau + sum J_c' f_c + J_e' w_e
    P, q, A, l, u = twb.build_wholebody_qp(fleet.tree, fleet.params, st, tk, ("imu",))
    for sol in (a, b):
        res = torch.einsum("bmn,bn->bm", A[:, :29], sol.qp.x) - u[:, :29]
        assert float(res.abs().max()) < 1e-2


def test_standing_fleet_is_the_posture_of_the_reference_test(fleet):
    q = fleet.q_ref.numpy()
    dq = np.random.default_rng(0).uniform(-0.02, 0.02, (B, 23))
    names, dof = fleet.tree.link_names, fleet.tree.dof_index
    nominal = np.zeros(23)
    for side in "lr":
        nominal[dof[names.index(f"{side}_upper_leg")]] = 0.25
        nominal[dof[names.index(f"{side}_lower_leg")]] = -0.5
        nominal[dof[names.index(f"{side}_ankle_1")]] = 0.25
    np.testing.assert_allclose(q, nominal + dq, atol=1e-15)
    assert not fleet.state.base_twist.any() and not fleet.state.joint_velocities.any()
    # the nominal posture's soles lie on z = 0
    one = standing_fleet(1, device="cpu", dtype=torch.float64)
    st = one.state._replace(joint_positions=torch.as_tensor(nominal)[None])
    poses = twb.forward_kinematics(one.tree, st.base_position, st.base_rotation,
                                   st.joint_positions)
    for f in ("l_sole", "r_sole"):
        assert abs(float(twb.rb.frame_pose(one.tree, poses, f)[1][0, 2])) < 1e-12
    with pytest.raises(RuntimeError, match="CUDA"):
        monkey = torch.cuda.is_available
        torch.cuda.is_available = lambda: False
        try:
            standing_fleet(2)                       # device=None means the GPU
        finally:
            torch.cuda.is_available = monkey
