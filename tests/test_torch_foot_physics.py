"""The physics of the port's rigid-foot rollout, as
``tests/test_foot_rollout.py`` checks the reference's, and the operands that
K5's wrapper takes (``ops/cuda/rollout.py``).

On ``make_problem``'s inputs (``tests/test_foot_rollout.py``), float32: the
fleet settles to the static equilibrium in 4000 steps of 1 ms, the settled
wrench carries the weight, and ``foot_dynamics``' force is the contact
model's. The wrapper takes k and b scalar, (B,) or (B, 1), the null pose per
lane or one for all, and runs the plain version for CPU tensors only.
"""

import numpy as np
import pytest
import torch

from blf_tpu_torch.models.contact import ContactState, contact_wrench
from blf_tpu_torch.models.foot import FootState, foot_dynamics, foot_rollout
from blf_tpu_torch.ops.cuda import rollout as rollout_kernel
from blf_tpu_torch.problems import foot_drop_fleet
from test_torch_foot import DT, assert_state_close, port_problem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def settled():
    """``make_problem(B=64)`` after 4000 steps of 1 ms, float32, as the
    reference's settling test runs it."""
    _, t = port_problem(64, torch.float32)
    return t, foot_rollout(*t, DT, 4000, backend="torch")


def test_settles_to_static_equilibrium(settled):
    """p_z -> -m g / (k A), velocities -> 0, R -> I."""
    (cp, fp, _, _, _), final = settled
    sink = float(fp.mass) * 9.81 / (float(cp.spring_coeff) * float(cp.length * cp.width))
    np.testing.assert_allclose(final.position[:, 2].numpy(), -sink, atol=1e-4)
    assert float(final.linear_velocity.abs().max()) < 1e-4
    assert float(final.angular_velocity.abs().max()) < 1e-3
    assert float((final.rotation - torch.eye(3)).abs().max()) < 1e-3


def test_equilibrium_wrench_balances_gravity(settled):
    (cp, fp, _, p0, R0), final = settled
    w = contact_wrench(cp, ContactState(*final, null_position=p0, null_rotation=R0))
    np.testing.assert_allclose(w[:, 2].numpy(), float(fp.mass) * 9.81, rtol=1e-3)
    assert float(w[:, :2].abs().max()) < 1e-2


def test_dynamics_matches_contact_model():
    """``foot_dynamics``' force term is exactly ``contact_wrench``'s."""
    _, (cp, fp, state, p0, R0) = port_problem(8, torch.float32)
    d = foot_dynamics(cp, fp, state, p0, R0)
    w = contact_wrench(cp, ContactState(*state, null_position=p0, null_rotation=R0))
    g = torch.tensor([0.0, 0.0, -9.81])
    np.testing.assert_allclose(d.linear_velocity.numpy(), (w[:, :3] / fp.mass + g).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_operands_broadcast_as_the_reference_accepts_them():
    """k and b scalar, (B,) or (B, 1); the null pose per lane, one pose, or a
    (B, ...) view with lane stride 0: the same rollout. Bad shapes raise."""
    _, (cp, fp, state, p0, R0) = port_problem(5, torch.float64, per_lane=True)
    run = lambda c, a, b: rollout_kernel.foot_rollout_fused(c, fp, state, a, b, dt=DT,
                                                            steps=20)
    base = run(cp, p0, R0)
    flat = cp._replace(spring_coeff=cp.spring_coeff[:, 0], damper_coeff=cp.damper_coeff[:, 0])
    assert_state_close(run(flat, p0, R0), base._asdict(), rtol=0, atol=0)
    one = run(cp, p0[0], R0[0])
    assert_state_close(run(cp, p0[0].expand(5, 3), R0[0].expand(5, 3, 3)), one._asdict(),
                       rtol=0, atol=0)
    assert_state_close(one, base._asdict(), rtol=0, atol=0)    # p0, R0 equal on every lane
    scalar = cp._replace(spring_coeff=cp.spring_coeff[0, 0], damper_coeff=cp.damper_coeff[0, 0])
    per_lane = cp._replace(spring_coeff=cp.spring_coeff[0].expand(5, 1),
                           damper_coeff=cp.damper_coeff[0].expand(5, 1))
    assert_state_close(run(scalar, p0, R0), run(per_lane, p0, R0)._asdict(), rtol=0, atol=0)
    with pytest.raises(ValueError, match="spring_coeff"):
        run(cp._replace(spring_coeff=torch.ones(4)), p0, R0)
    with pytest.raises(ValueError, match="null_rotation"):
        run(cp, p0, R0[:, :2])
    with pytest.raises(ValueError, match=r"position must be \(B, 3\)"):
        rollout_kernel.foot_rollout_fused(cp, fp, FootState(*(x[None] for x in state)), p0,
                                          R0, dt=DT, steps=1)


def test_wrapper_runs_the_plain_version_on_cpu_and_raises_elsewhere():
    """CPU tensors: the plain version, counted as such, not as a launch; any
    other device raises; ``foot_rollout`` takes only its two backends."""
    fleet = foot_drop_fleet(7, device="cpu")
    args = (fleet.cparams, fleet.fparams, fleet.state, fleet.null_position,
            fleet.null_rotation)
    rollout_kernel.reset_counts()
    out = foot_rollout(*args, fleet.dt, 3, backend="cuda")
    assert rollout_kernel.reference_count() == 1 and rollout_kernel.launch_count() == 0
    assert_state_close(out, rollout_kernel.foot_rollout_fused_reference(
        *args, dt=fleet.dt, steps=3)._asdict(), rtol=0, atol=0)
    assert isinstance(out, FootState) and out.rotation.shape == (7, 3, 3)
    meta = FootState(*(torch.zeros_like(x, device="meta") for x in fleet.state))
    with pytest.raises(ValueError, match="cpu or cuda"):
        rollout_kernel.foot_rollout_fused(fleet.cparams, fleet.fparams, meta,
                                          fleet.null_position, fleet.null_rotation,
                                          dt=fleet.dt, steps=3)
    with pytest.raises(ValueError, match="unknown backend"):
        foot_rollout(*args, fleet.dt, 3, backend="pallas")
