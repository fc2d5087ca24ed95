"""The port's stiff ROS2-W integrator (``integrate_rosenbrock``,
``rosenbrock_operator``) against ``blf_tpu.ops.integrators``.

Float64, the same seeded numpy inputs on both sides, 1e-10:

* the closed forms of ``tests/test_integrators.py`` (the step response of
  ``xdot = [[0, 1], [-2, -2]] x + [0, 2] u``) and a stiff decay far beyond the
  explicit stability limit, on a state that nests a dict (so the flattening
  order, fields in declaration order and dict keys sorted, is held too);
* the control stack's stiff plant path on the 6-DoF biped of
  ``tests/test_torch_wbc_loop.py``: the stage operator entry by entry (D =
  6 + 6 + 3 + 9 + 6 = 30, built from the sole-ground path with frozen contact
  Jacobians and the lagged M^-1, as ``make_fleet_stack_step`` builds it) and
  two substeps of the full contact-closed dynamics under it.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blf_tpu.models import kinematics as jkin
from blf_tpu.models import rigid_body as jrb
from blf_tpu.mpc import stack as jstack
from blf_tpu.mpc.wholebody import WholeBodyParams as JWholeBodyParams
from blf_tpu.ops import integrators as jint
from blf_tpu_torch.models import kinematics as tkin
from blf_tpu_torch.models import rigid_body as trb
from blf_tpu_torch.mpc import stack as tstack
from blf_tpu_torch.mpc.wholebody import WholeBodyParams
from blf_tpu_torch.ops import integrators as tint
from blf_tpu_torch.ops.lie import so3_exp
from test_torch_wbc_loop import SOLES, make_biped, reference_jit

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
A = np.array([[0.0, 1.0], [-2.0, -2.0]])
BU = np.array([0.0, 2.0])


class JState(NamedTuple):
    x: object
    nested: dict


class TState(NamedTuple):
    x: object
    nested: dict


def lti(lib, cls, mat, bu, lam):
    """The step response system on ``x`` and, under two dict keys given out of
    order, a stiff decay ``rdot = -lam (r - 1)`` and a slow one."""
    def f(s, u, t):
        return cls(x=s.x @ mat.T + bu * u,
                   nested={"slow": -0.5 * s.nested["slow"],
                           "fast": -lam * (s.nested["fast"] - 1.0)})
    return f


def both(lam, lanes):
    rng = np.random.default_rng(1)
    x0 = np.zeros((lanes, 2))
    fast, slow = rng.normal(size=(lanes, 2, 2)), rng.normal(size=(lanes, 3))
    fj = lti(jnp, JState, jnp.asarray(A), jnp.asarray(BU), lam)
    ft = lti(torch, TState, torch.as_tensor(A), torch.as_tensor(BU), lam)
    sj = JState(jnp.asarray(x0), {"slow": jnp.asarray(slow), "fast": jnp.asarray(fast)})
    st = TState(torch.as_tensor(x0), {"slow": torch.as_tensor(slow), "fast": torch.as_tensor(fast)})
    return fj, ft, sj, st


def test_step_response_and_stiff_decay_match_the_reference_and_the_closed_form():
    lam, lanes, dt, steps = 1e4, 3, 1e-2, 200
    fj, ft, sj, st = both(lam, lanes)
    ref = reference_jit(jax.vmap(lambda s: jint.integrate_rosenbrock(
        fj, s, dt=dt, num_steps=steps, u=jnp.ones(1))))(sj)
    out = tint.integrate_rosenbrock(ft, st, dt=dt, num_steps=steps,
                                    u=torch.ones(1, dtype=torch.float64))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), **TOL)
    for key in ("slow", "fast"):
        np.testing.assert_allclose(out.nested[key].numpy(), np.asarray(ref.nested[key]), **TOL)
    # the closed form at t = 2 s (tests/test_integrators.py), to ROS2's
    # second order at this step
    t = dt * steps
    closed = np.array([1 - np.exp(-t) * (np.cos(t) + np.sin(t)), 2 * np.exp(-t) * np.sin(t)])
    np.testing.assert_allclose(out.x.numpy(), np.broadcast_to(closed, (lanes, 2)), atol=1e-4)
    # dt lam = 100: explicit steps would blow up; L-stable ROS2-W settles on 1
    np.testing.assert_allclose(out.nested["fast"].numpy(), 1.0, atol=1e-10)


def test_operator_matches_the_reference_entry_by_entry():
    fj, ft, sj, st = both(50.0, 2)
    kw = dict(dt=2.5e-3, t0=0.1)
    ref = jax.vmap(lambda s: jint.rosenbrock_operator(fj, s, u=jnp.ones(1), **kw))(sj)
    out = tint.rosenbrock_operator(ft, st, u=torch.ones(1, dtype=torch.float64), **kw)
    assert tuple(out.shape) == (2, 9, 9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # the flat order is ravel_pytree's: x, then nested["fast"], then nested["slow"]
    flat, unflatten = tint.flatten_state(st)
    assert torch.equal(flat[:, 2:6], st.nested["fast"].reshape(2, 4))
    assert torch.equal(unflatten(flat).nested["slow"], st.nested["slow"])


@functools.lru_cache(maxsize=None)
def biped_plant():
    """Four lanes of the biped, drawn about its standing posture 1 mm deep in
    the default stack ground, and the plant functions of both packages."""
    lanes, n = 4, 6
    rng = np.random.default_rng(2)
    state = dict(
        base_twist=rng.normal(0, 0.05, (lanes, 6)),
        joint_velocities=rng.normal(0, 0.1, (lanes, n)),
        base_position=np.array([0.0, 0.0, 0.5835]) + rng.normal(0, 5e-4, (lanes, 3)),
        base_rotation=so3_exp(torch.as_tensor(rng.normal(0, 0.01, (lanes, 3)))).numpy(),
        joint_positions=np.array([0.25, -0.5, 0.25, 0.25, -0.5, 0.25])
        + rng.uniform(-0.02, 0.02, (lanes, n)))
    torques = rng.normal(0, 5.0, (lanes, n))
    push = np.concatenate([rng.uniform(-8, 8, (lanes, 2)), np.zeros((lanes, 4))], axis=-1)
    anchors = {f: np.array([0.025, s * 0.08, 2e-3]) for f, s in zip(SOLES, (1.0, -1.0))}
    config = dict(physics_per_wbc=2)

    jtree = make_biped(jkin.KinematicTreeBuilder, push_frame=True)
    jground = jstack._default_ground(jtree, JWholeBodyParams(contact_frames=SOLES),
                                     jstack.StackConfig(**config))
    jfun = jstack._plant_functions(
        jtree, jground, {f: (jnp.eye(3), jnp.asarray(p)) for f, p in anchors.items()}, "imu")
    ttree = make_biped(tkin.KinematicTreeBuilder, push_frame=True)
    tground = tstack._default_ground(ttree, WholeBodyParams(contact_frames=SOLES),
                                     tstack.StackConfig(**config))
    tfun = tstack._plant_functions(
        ttree, tground,
        {f: (torch.eye(3, dtype=torch.float64), torch.as_tensor(p)) for f, p in anchors.items()},
        "imu")
    return jtree, jfun, ttree, tfun, state, torques, push


def test_stiff_plant_operator_and_substeps_match_the_reference():
    jtree, (_, jfdyn, jstiff), ttree, (_, tfdyn, tstiff), state, torques, push = biped_plant()
    dt = 0.01 / 2

    def jax_lane(s, tau, pw):
        M = jrb.mass_matrix(jtree, s.base_position, s.base_rotation, s.joint_positions)
        minv = jnp.linalg.inv(M)
        poses = jkin.forward_kinematics(jtree, s.base_position, s.base_rotation,
                                        s.joint_positions)
        jfro = {f: jkin.frame_jacobian(jtree, poses, f) for f in SOLES}
        op = jint.rosenbrock_operator(lambda x, u_, t_: jstiff(x, minv, jfro), s,
                                      u=jnp.zeros(6), dt=dt)
        nxt = jint.integrate_rosenbrock(lambda x, u, t: jfdyn(x, u, t, pw, minv=minv), s,
                                        dt=dt, num_steps=2, u=tau, operator=op)
        return op, nxt

    ref_op, ref_next = reference_jit(jax.vmap(jax_lane))(
        jrb.FloatingBaseState(**{k: jnp.asarray(v) for k, v in state.items()}),
        jnp.asarray(torques), jnp.asarray(push))

    s = trb.FloatingBaseState(**{k: torch.as_tensor(v) for k, v in state.items()})
    minv = torch.linalg.inv(trb.mass_matrix(ttree, s.base_position, s.base_rotation,
                                            s.joint_positions))
    poses = tkin.forward_kinematics(ttree, s.base_position, s.base_rotation, s.joint_positions)
    jfro = {f: tkin.frame_jacobian(ttree, poses, f) for f in SOLES}
    op = tint.rosenbrock_operator(lambda x, u_, t_: tstiff(x, minv, jfro), s,
                                  u=torch.zeros(6, dtype=torch.float64), dt=dt)
    assert tuple(op.shape) == (4, 30, 30)
    np.testing.assert_allclose(op.numpy(), np.asarray(ref_op), **TOL)
    pw = torch.as_tensor(push)
    nxt = tint.integrate_rosenbrock(lambda x, u, t: tfdyn(x, u, t, pw, minv=minv), s,
                                    dt=dt, num_steps=2, u=torch.as_tensor(torques), operator=op)
    for name in trb.FloatingBaseState._fields:
        np.testing.assert_allclose(getattr(nxt, name).numpy(), np.asarray(getattr(ref_next, name)),
                                   err_msg=name, **TOL)
    # the operator damps the sole modes: it is not the identity
    assert float((op - torch.eye(30, dtype=torch.float64)).abs().max()) > 1e-2
