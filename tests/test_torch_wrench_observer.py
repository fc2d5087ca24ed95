"""The port's momentum observer against ``blf_tpu.estimators.wrench_observer``.

Float64, on the 6-DoF biped of ``tests/test_torch_wbc_loop.py`` (with its
push frame on the pelvis), the same seeded numpy states and torques on both
sides. ``Mdot nu`` is a ``jvp`` of the mass-matrix map on both sides and the
bias forces another; the filter is a handful of products: 1e-10 on the
observer state and residual after three steps and along a scan, on the
normal equations ``(J J' + reg I, J r)`` and on the push-frame wrench they
give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blf_tpu.estimators import wrench_observer as jobs
from blf_tpu.models import kinematics as jkin
from blf_tpu.models import rigid_body as jrb
from blf_tpu_torch.convert import (momentum_observer_state_from_numpy,
                                   momentum_observer_state_to_numpy)
from blf_tpu_torch.estimators import wrench_observer as tobs
from blf_tpu_torch.models import kinematics as tkin
from blf_tpu_torch.models import rigid_body as trb
from blf_tpu_torch.ops.lie import so3_exp
from test_torch_wbc_loop import make_biped, reference_jit

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-10)
LANES, T, N = 3, 3, 6
FRAMES = ("imu", "l_sole")    # the normal equations of two frames
PUSH = ("imu",)               # the stack's attribution: one frame, G 6 x 6
GAIN, DT = 60.0, 0.01


def samples():
    """``T`` sampled states (T, LANES, ...) and torques (T, LANES, n)."""
    rng = np.random.default_rng(4)
    return dict(
        base_twist=rng.normal(0, 0.2, (T, LANES, 6)),
        joint_velocities=rng.normal(0, 0.5, (T, LANES, N)),
        base_position=rng.normal(0, 0.05, (T, LANES, 3)) + [0.0, 0.0, 0.58],
        base_rotation=so3_exp(torch.as_tensor(rng.normal(0, 0.1, (T, LANES, 3)))).numpy(),
        joint_positions=rng.uniform(-0.5, 0.5, (T, LANES, N))), rng.normal(0, 5.0, (T, LANES, N))


def test_observer_steps_scan_and_attribution_match_the_reference():
    states, torques = samples()
    jtree = make_biped(jkin.KinematicTreeBuilder, push_frame=True)
    ttree = make_biped(tkin.KinematicTreeBuilder, push_frame=True)
    jstates = jrb.FloatingBaseState(**{k: jnp.asarray(v) for k, v in states.items()})
    tstates = trb.FloatingBaseState(**{k: torch.as_tensor(v) for k, v in states.items()})
    first = lambda s: type(s)(*(leaf[0] for leaf in s))

    @reference_jit
    def reference(states, torques):
        def lane(st, tau):
            params, obs0 = jobs.init_momentum_observer(
                jtree, jax.tree_util.tree_map(lambda a: a[0], st), GAIN, DT)
            obs, rs = jobs.momentum_observer_scan(jtree, params, obs0, st, tau)
            last = jax.tree_util.tree_map(lambda a: a[-1], st)
            G, Jr = jobs.wrench_normal_equations(jtree, last, FRAMES, rs[-1])
            f = jobs.wrenches_from_residual(jtree, last, PUSH, rs[-1])
            return obs0, obs, rs, G, Jr, f
        # lanes lead in the port; the reference maps its single-lane filter
        return jax.vmap(lane, in_axes=(1, 1))(states, torques)

    obs0_r, obs_r, rs_r, G_r, Jr_r, f_r = reference(jstates, jnp.asarray(torques))

    params, obs0 = tobs.init_momentum_observer(ttree, first(tstates), GAIN, DT)
    np.testing.assert_allclose(obs0.integral.numpy(), np.asarray(obs0_r.integral), **TOL)
    assert float(obs0.residual.abs().max()) == 0.0

    # step by step, and as a scan over the leading time axis
    obs, rs = obs0, []
    for k in range(T):
        obs, r = tobs.momentum_observer_step(ttree, params, obs,
                                             type(tstates)(*(leaf[k] for leaf in tstates)),
                                             torch.as_tensor(torques[k]))
        rs.append(r)
    obs_s, rs_s = tobs.momentum_observer_scan(ttree, params, obs0, tstates,
                                              torch.as_tensor(torques))
    for got in (obs, obs_s):
        np.testing.assert_allclose(got.integral.numpy(), np.asarray(obs_r.integral), **TOL)
        np.testing.assert_allclose(got.residual.numpy(), np.asarray(obs_r.residual), **TOL)
    np.testing.assert_allclose(rs_s.numpy(), np.swapaxes(np.asarray(rs_r), 0, 1), **TOL)
    np.testing.assert_allclose(torch.stack(rs).numpy(), rs_s.numpy(), **TOL)

    last = type(tstates)(*(leaf[-1] for leaf in tstates))
    G, Jr = tobs.wrench_normal_equations(ttree, last, FRAMES, rs_s[-1])
    assert tuple(G.shape) == (LANES, 12, 12) and tuple(Jr.shape) == (LANES, 12)
    np.testing.assert_allclose(G.numpy(), np.asarray(G_r), **TOL)
    np.testing.assert_allclose(Jr.numpy(), np.asarray(Jr_r), **TOL)
    # (with both frames G has a condition number of some 1e9 on this robot,
    # so only the normal equations themselves are compared there)
    f = tobs.wrenches_from_residual(ttree, last, PUSH, rs_s[-1])
    assert tuple(f.shape) == (LANES, 1, 6)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_r), **TOL)

    # the observer state crosses between the packages as numpy
    back = momentum_observer_state_from_numpy(
        momentum_observer_state_to_numpy(obs), device="cpu", dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(back, obs))

