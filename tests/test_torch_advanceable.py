"""The port's ``Advanceable`` protocol (``ops/advanceable.py``) against
``blf_tpu.ops.advanceable``.

``tests/test_advanceable.py``'s cases on both sides: the contract check
raises where the reference's raises, with the same message, and passes
where it passes; ``advance_scan`` drives the same sequences to the same
outputs; over the port's ``rls_step`` it equals a plain loop bit for bit and
the reference's scan over its ``rls_step`` to 1e-12 (float64).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.estimators import rls as jrls
from blf_tpu.ops import advanceable as jadv
from blf_tpu_torch.estimators import rls as trls
from blf_tpu_torch.ops import advanceable as tadv
from blf_tpu_torch.ops.integrators import rk4_step

torch.set_num_threads(1)

# (step, carry, inputs) built for either package by its array module
CONTRACT = {
    "good": (lambda xp: (lambda c, x: (c + x, c * 2.0)), lambda xp: (xp.zeros(3), xp.ones(3))),
    "non_tuple_return": (lambda xp: (lambda c: c), lambda xp: (xp.zeros(3),)),
    "shape_change": (lambda xp: (lambda c: (xp.concatenate([c, c]), c)),
                     lambda xp: (xp.zeros(3),)),
    "dtype_change": (lambda xp: (lambda c: (c.astype(xp.float16) if xp is jnp
                                            else c.to(torch.float16), c)),
                     lambda xp: (xp.zeros(3),)),
    "treedef_change": (lambda xp: (lambda c: ({"a": c}, c)), lambda xp: (xp.zeros(3),)),
}


class TorchNamespace:
    zeros = staticmethod(lambda n: torch.zeros(n, dtype=torch.float64))
    ones = staticmethod(lambda n: torch.ones(n, dtype=torch.float64))
    concatenate = staticmethod(torch.cat)


@pytest.mark.parametrize("case", sorted(CONTRACT))
def test_contract_check_raises_where_the_reference_raises(case):
    make_step, make_args = CONTRACT[case]
    outcomes = []
    for xp, module in ((jnp, jadv), (TorchNamespace, tadv)):
        try:
            module.check_advanceable(make_step(xp), *make_args(xp))
            outcomes.append(None)
        except TypeError as err:
            outcomes.append(re.split("[:;]", str(err))[0])     # the message, not the types
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (case == "good")


def test_advance_scan_drives_sequences_as_the_reference():
    def step(c, x):
        c = c + x
        return c, c

    ref = jadv.advance_scan(step, jnp.asarray(0.0), jnp.asarray([1.0, 2.0, 3.0]))
    got = tadv.advance_scan(step, torch.tensor(0.0, dtype=torch.float64),
                            torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert float(got[0]) == float(ref[0]) == 6.0
    # autonomous, with a length
    ref = jadv.advance_scan(lambda c: (c * 2.0, c), jnp.asarray(1.0), length=4)
    got = tadv.advance_scan(lambda c: (c * 2.0, c), torch.tensor(1.0), length=4)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert float(got[0]) == 16.0
    # a tree of inputs is passed as one argument
    pair = lambda c, ab: (c + ab[0] * ab[1], {"c": c})
    ref = jadv.advance_scan(pair, jnp.asarray(0.0), (jnp.ones(3), 2.0 * jnp.ones(3)))
    got = tadv.advance_scan(pair, torch.tensor(0.0, dtype=torch.float64),
                            (torch.ones(3, dtype=torch.float64),
                             2.0 * torch.ones(3, dtype=torch.float64)))
    assert float(got[0]) == float(ref[0]) == 6.0
    np.testing.assert_array_equal(got[1]["c"].numpy(), np.asarray(ref[1]["c"]))


def test_advance_scan_over_rls_step_is_the_loop_and_the_reference():
    T = 50
    rng = np.random.default_rng(0)
    A = rng.normal(size=(T, 4, 2, 2))                  # 4 lanes on a leading axis
    y = rng.normal(size=(T, 4, 2))
    t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64))
    params = trls.RLSParams(t(0.98), t(1e-2 * np.eye(2)))
    state = trls.RLSState(t(np.zeros((4, 2))), t(np.broadcast_to(np.eye(2), (4, 2, 2))))

    def step(carry, Ay):
        nxt = trls.rls_step(params, carry, *Ay)
        return nxt, nxt.theta

    tadv.check_advanceable(step, state, (t(A[0]), t(y[0])))
    final, thetas = tadv.advance_scan(step, state, (t(A), t(y)))
    carry, loop = state, []
    for k in range(T):
        carry = trls.rls_step(params, carry, t(A[k]), t(y[k]))
        loop.append(carry.theta)
    assert torch.equal(thetas, torch.stack(loop))
    assert torch.equal(final.covariance, carry.covariance)

    jparams = jrls.RLSParams(jnp.asarray(0.98), jnp.asarray(1e-2 * np.eye(2)))
    jstate = jrls.RLSState(jnp.zeros((4, 2)), jnp.broadcast_to(jnp.eye(2), (4, 2, 2)))
    jstep = lambda c, Ay: (lambda n: (n, n.theta))(jrls.rls_step(jparams, c, *Ay))
    ref_final, ref_thetas = jadv.advance_scan(jstep, jstate, (jnp.asarray(A), jnp.asarray(y)))
    np.testing.assert_allclose(thetas.numpy(), np.asarray(ref_thetas), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(final.covariance.numpy(), np.asarray(ref_final.covariance),
                               rtol=1e-12, atol=1e-12)


def test_integrator_step_conforms():
    """``test_integrator_step``: a carry of (state, time) through ``rk4_step``."""
    def step(carry, u):
        x, time = carry
        return (rk4_step(lambda x, u, t: -x + u, x, u, time, 0.01), time + 0.01), x

    tadv.check_advanceable(step, (torch.ones(3), torch.tensor(0.0)), torch.zeros(3))
    assert isinstance(step, tadv.Advanceable)
