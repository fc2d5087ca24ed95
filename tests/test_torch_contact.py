"""The port's contact model against ``blf_tpu.models.contact``, and the
rigid-body engine closed with it (``make_contact_dynamics``).

Float64, the same seeded numpy inputs on both sides. Every function of the
model is a closed-form patch integral, the same few products and sums on
both sides: held to 1e-12. ``make_contact_dynamics`` runs the articulated
dynamics of the 6-DoF biped of ``tests/test_torch_wbc_loop.py`` on both soles
(a Cholesky solve of the 12 x 12 mass matrix in two libraries): 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models import contact as jcontact
from blf_tpu.models import kinematics as jkin
from blf_tpu.models import rigid_body as jrb
from blf_tpu_torch.convert import contact_params_from_numpy, contact_params_to_numpy
from blf_tpu_torch.models import contact as tcontact
from blf_tpu_torch.models import kinematics as tkin
from blf_tpu_torch.models import rigid_body as trb
from blf_tpu_torch.ops.lie import so3_exp
from test_torch_wbc_loop import SOLES, make_biped, reference_jit

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
B = 7
RNG = np.random.default_rng(3)
PARAMS = dict(length=0.12, width=0.09, spring_coeff=2000.0, damper_coeff=100.0)
STATE = dict(
    position=RNG.normal(0, 0.02, (B, 3)),
    rotation=so3_exp(torch.as_tensor(RNG.normal(0, 0.3, (B, 3)))).numpy(),
    linear_velocity=RNG.uniform(-1, 1, (B, 3)),
    angular_velocity=RNG.uniform(-1, 1, (B, 3)),
    null_position=RNG.normal(0, 0.01, (B, 3)),
    null_rotation=so3_exp(torch.as_tensor(RNG.normal(0, 0.05, (B, 3)))).numpy(),
)
ACC = RNG.normal(size=(B, 6))
# patch points, half of them outside the patch
XS, YS = RNG.uniform(-0.1, 0.1, B), RNG.uniform(-0.08, 0.08, B)


def both():
    jp = jcontact.ContactParams(**{k: jnp.asarray(v) for k, v in PARAMS.items()})
    tp = contact_params_from_numpy(PARAMS, device="cpu", dtype=torch.float64)
    js = jcontact.ContactState(**{k: jnp.asarray(v) for k, v in STATE.items()})
    ts = tcontact.ContactState(**{k: torch.as_tensor(v) for k, v in STATE.items()})
    return jp, tp, js, ts


@pytest.mark.parametrize("name", ["contact_wrench", "autonomous_dynamics",
                                  "control_matrix", "regressor"])
def test_closed_forms_match_the_reference(name):
    jp, tp, js, ts = both()
    out = getattr(tcontact, name)(tp, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(getattr(jcontact, name)(jp, js)), **TOL)
    # batched as one call, lane by lane as the reference's single-sample calls
    lane = getattr(tcontact, name)(tp, tcontact.ContactState(*(f[3] for f in ts)))
    np.testing.assert_allclose(lane.numpy(), out[3].numpy(), **TOL)


def test_wrench_rate_and_regressor_identity():
    jp, tp, js, ts = both()
    rate = tcontact.wrench_rate(tp, ts, torch.as_tensor(ACC))
    np.testing.assert_allclose(rate.numpy(), np.asarray(jcontact.wrench_rate(jp, js, ACC)), **TOL)
    # w = A [k; b], as the reference's own test holds it
    kb = torch.tensor([PARAMS["spring_coeff"], PARAMS["damper_coeff"]], dtype=torch.float64)
    np.testing.assert_allclose((tcontact.regressor(tp, ts) @ kb).numpy(),
                               tcontact.contact_wrench(tp, ts).numpy(), **TOL)


@pytest.mark.parametrize("name", ["force_at_point", "torque_at_point"])
def test_pointwise_law_matches_the_reference(name):
    jp, tp, js, ts = both()
    out = getattr(tcontact, name)(tp, ts, XS, YS)
    ref = getattr(jcontact, name)(jp, js, jnp.asarray(XS), jnp.asarray(YS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    outside = (np.abs(XS) > PARAMS["length"] / 2) | (np.abs(YS) > PARAMS["width"] / 2)
    assert outside.any() and (~outside).any()
    assert (out.numpy()[outside] == 0).all()


def test_contact_params_round_trip():
    tp = contact_params_from_numpy(PARAMS, device="cpu", dtype=torch.float64)
    back = contact_params_to_numpy(tp)
    assert back == {k: np.asarray(v) for k, v in PARAMS.items()}
    jp = jcontact.ContactParams(**{k: jnp.asarray(v) for k, v in PARAMS.items()})
    assert contact_params_from_numpy(jp, device="cpu", dtype=torch.float64) == tp


def test_contact_dynamics_on_the_biped_matches_the_reference():
    """The biped standing about 1 cm deep in two compliant soles, from drawn
    states: each lane's state derivative from the live frame kinematics, the
    patch wrenches and the articulated dynamics."""
    lanes, n = 5, 6
    rng = np.random.default_rng(5)
    q = np.array([0.25, -0.5, 0.25, 0.25, -0.5, 0.25]) + rng.uniform(-0.05, 0.05, (lanes, n))
    state = dict(
        base_twist=rng.normal(0, 0.1, (lanes, 6)),
        joint_velocities=rng.normal(0, 0.2, (lanes, n)),
        base_position=np.array([0.0, 0.0, 0.575]) + rng.normal(0, 0.002, (lanes, 3)),
        base_rotation=so3_exp(torch.as_tensor(rng.normal(0, 0.05, (lanes, 3)))).numpy(),
        joint_positions=q)
    null = {f: (np.eye(3), np.array([0.025, s * 0.08, 0.0]))
            for f, s in zip(SOLES, (1.0, -1.0))}
    kw = dict(rho=1.0)
    ground = (0.14, 0.08, 5e6, 3e4)       # a sole patch, stiff enough to carry 22 kg

    jtree = make_biped(jkin.KinematicTreeBuilder)
    jparams = jcontact.ContactParams(*(jnp.asarray(v) for v in ground))
    jdyn = jrb.make_contact_dynamics(jtree, {f: jparams for f in SOLES}, **kw)
    jnull = {f: tuple(jnp.asarray(a) for a in v) for f, v in null.items()}
    ref = reference_jit(jax.vmap(lambda s: jdyn(s, jnull)))(
        jrb.FloatingBaseState(**{k: jnp.asarray(v) for k, v in state.items()}))

    ttree = make_biped(tkin.KinematicTreeBuilder)
    tparams = tcontact.ContactParams(*(torch.tensor(v, dtype=torch.float64) for v in ground))
    tdyn = trb.make_contact_dynamics(ttree, {f: tparams for f in SOLES}, **kw)
    out = tdyn(trb.FloatingBaseState(**{k: torch.as_tensor(v) for k, v in state.items()}),
               {f: tuple(torch.as_tensor(a) for a in v) for f, v in null.items()})
    for name in trb.FloatingBaseState._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    # the soles carry the robot: without them every lane falls at about g
    free = trb.floating_base_dynamics(
        ttree, trb.FloatingBaseState(**{k: torch.as_tensor(v) for k, v in state.items()}),
        trb.FloatingBaseInput(torch.zeros(lanes, n, dtype=torch.float64), {}), rho=1.0)
    assert float((out.base_twist[:, :3] - free.base_twist[:, :3]).abs().min()) > 1.0
