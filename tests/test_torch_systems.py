"""The port's ``models/systems.py`` against ``blf_tpu.models.systems``.

Float64, the same seeded numpy inputs on both sides: ``lti_dynamics`` is two
batched products, ``floating_base_kinematics`` the Baumgarte rate of
``ops/lie.py`` (a 3 x 3 inverse in two libraries): 1e-12. ``LTIParams.validate``
raises the same errors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models import systems as jsys
from blf_tpu_torch.models import systems as tsys
from blf_tpu_torch.ops.lie import so3_exp

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
RNG = np.random.default_rng(11)


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)], ids=["single", "fleet", "nested"])
def test_lti_dynamics_matches_the_reference(batch):
    A = RNG.normal(size=batch + (5, 5))
    B = RNG.normal(size=batch + (5, 2))
    x, u = RNG.normal(size=batch + (5,)), RNG.normal(size=batch + (2,))
    out = tsys.lti_dynamics(tsys.LTIParams(torch.as_tensor(A), torch.as_tensor(B)),
                            torch.as_tensor(x), torch.as_tensor(u), 0.3)
    ref = jsys.lti_dynamics(jsys.LTIParams(jnp.asarray(A), jnp.asarray(B)), jnp.asarray(x),
                            jnp.asarray(u), 0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shapes, message", [
    (((3, 4), (3, 2)), "A must be square"),
    (((3, 3), (4, 2)), "A and B must have the same number of rows"),
    (((3, 3), (3, 2)), None)], ids=["not_square", "rows", "valid"])
def test_validate_raises_what_the_reference_raises(shapes, message):
    (a, b) = (np.ones(s) for s in shapes)
    port = tsys.LTIParams(torch.as_tensor(a), torch.as_tensor(b))
    ref = jsys.LTIParams(jnp.asarray(a), jnp.asarray(b))
    if message is None:
        out = port.validate()
        assert isinstance(out, tsys.LTIParams)
        np.testing.assert_array_equal(out.B.numpy(), np.asarray(ref.validate().B))
        return
    for params in (port, ref):
        with pytest.raises(ValueError, match=message):
            params.validate()


@pytest.mark.parametrize("rho", [0.0, 10.0])
def test_floating_base_kinematics_matches_the_reference(rho):
    n, B = 4, 6
    rot = so3_exp(torch.as_tensor(RNG.normal(0, 0.5, (B, 3))))
    rot = rot + torch.as_tensor(RNG.normal(0, 1e-3, (B, 3, 3)))    # off SO(3): Baumgarte
    pos, q = RNG.normal(size=(B, 3)), RNG.normal(size=(B, n))
    twist, qd = RNG.normal(size=(B, 6)), RNG.normal(size=(B, n))
    out = tsys.floating_base_kinematics(
        tsys.FloatingBaseKinState(torch.as_tensor(pos), rot, torch.as_tensor(q)),
        tsys.FloatingBaseKinInput(torch.as_tensor(twist), torch.as_tensor(qd)), rho=rho)
    ref = jsys.floating_base_kinematics(
        jsys.FloatingBaseKinState(jnp.asarray(pos), jnp.asarray(rot.numpy()), jnp.asarray(q)),
        jsys.FloatingBaseKinInput(jnp.asarray(twist), jnp.asarray(qd)), rho=rho)
    assert type(out).__name__ == "FloatingBaseKinState"
    for name in tsys.FloatingBaseKinState._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
