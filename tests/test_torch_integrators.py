"""The port's fixed-step integrators against ``blf_tpu.ops.integrators``.

Float64; the same dynamics written once for each side, the same seeded numpy
inputs. Tolerance 1e-12: a step is the same handful of sums and products on
both sides, and 40 steps of a contractive system do not grow the difference.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.ops import integrators as jint
from blf_tpu_torch.ops import integrators as tint

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
RNG = np.random.default_rng(0)
B, STEPS, DT = 5, 40, 0.01
A = RNG.normal(size=(3, 3)) - 2.0 * np.eye(3)
X0 = RNG.normal(size=(B, 3))
R0 = RNG.normal(size=(B, 2, 2))
U_CONST = RNG.normal(size=(B, 3))
U_STEPS = RNG.normal(size=(STEPS, B, 3))


class JState(NamedTuple):
    x: object
    nested: dict


class TState(NamedTuple):
    x: object
    nested: dict


def dynamics(lib, state_cls, mat):
    """A damped linear system forced by u, with a time-dependent term, over a
    NamedTuple state that nests a dict (as the rigid-body input does)."""
    def f(s, u, t):
        forcing = 0.0 if u is None else u
        dx = s.x @ mat.T + forcing + lib.sin(3.0 * t + s.x)
        return state_cls(x=dx, nested={"r": -0.5 * s.nested["r"] + 0.1 * t})
    return f


def both_sides():
    fj = dynamics(jnp, JState, jnp.asarray(A))
    ft = dynamics(torch, TState, torch.as_tensor(A))
    sj = JState(jnp.asarray(X0), {"r": jnp.asarray(R0)})
    st = TState(torch.as_tensor(X0), {"r": torch.as_tensor(R0)})
    return fj, ft, sj, st


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("inputs", ["none", "constant", "per_step"])
def test_integrate_matches_the_reference(method, inputs):
    fj, ft, sj, st = both_sides()
    kj = {"u": jnp.asarray(U_CONST)} if inputs == "constant" else (
        {"us": jnp.asarray(U_STEPS)} if inputs == "per_step" else {})
    kt = {"u": torch.as_tensor(U_CONST)} if inputs == "constant" else (
        {"us": torch.as_tensor(U_STEPS)} if inputs == "per_step" else {})
    ref, ref_traj = jint.integrate(fj, sj, dt=DT, num_steps=STEPS, t0=0.3, method=method,
                                   save_trajectory=True, **kj)
    out, traj = tint.integrate(ft, st, dt=DT, num_steps=STEPS, t0=0.3, method=method,
                               save_trajectory=True, **kt)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), **TOL)
    np.testing.assert_allclose(out.nested["r"].numpy(), np.asarray(ref.nested["r"]), **TOL)
    assert tuple(traj.x.shape) == (STEPS + 1, B, 3)
    np.testing.assert_allclose(traj.x.numpy(), np.asarray(ref_traj.x), **TOL)
    np.testing.assert_allclose(traj.nested["r"].numpy(), np.asarray(ref_traj.nested["r"]), **TOL)
    # without the trajectory only the final state comes back
    alone = tint.integrate(ft, st, dt=DT, num_steps=STEPS, t0=0.3, method=method, **kt)
    assert torch.equal(alone.x, out.x)


@pytest.mark.parametrize("name", ["forward_euler_step", "midpoint_step", "rk4_step"])
def test_single_steps_match(name):
    fj, ft, sj, st = both_sides()
    ref = getattr(jint, name)(fj, sj, jnp.asarray(U_CONST), 0.2, DT)
    out = getattr(tint, name)(ft, st, torch.as_tensor(U_CONST), 0.2, DT)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), **TOL)


def test_rk4_meets_a_closed_form():
    """xdot = -x: RK4's error after 1 s at dt = 0.01 is ~1e-11."""
    x = tint.integrate(lambda s, u, t: -s, torch.ones(3, dtype=torch.float64), dt=0.01,
                       num_steps=100, method="rk4")
    np.testing.assert_allclose(x.numpy(), np.exp(-1.0), atol=1e-10)


def test_bad_arguments_and_what_is_not_ported():
    _, ft, _, st = both_sides()
    with pytest.raises(ValueError, match="unknown method"):
        tint.integrate(ft, st, dt=DT, num_steps=2, method="rk5")
    with pytest.raises(ValueError, match="not both"):
        tint.integrate(ft, st, dt=DT, num_steps=2, u=1, us=2)
    with pytest.raises(TypeError, match="unsupported state node"):
        tint.integrate(lambda s, u, t: s, "state", dt=DT, num_steps=1)
    assert set(tint.STEP_FUNCTIONS) == set(jint.STEP_FUNCTIONS)
    # nothing of the reference module is left unported (the ROS2-W pair is
    # held to it in tests/test_torch_rosenbrock.py)
    assert set(jint.__all__) <= set(tint.__all__)
    for fn in (tint.integrate_rosenbrock, tint.rosenbrock_operator):
        with pytest.raises(TypeError, match="unsupported state node"):
            fn(lambda s, u, t: s, "state", dt=DT, **({"num_steps": 1} if fn is
                                                      tint.integrate_rosenbrock else {}))
