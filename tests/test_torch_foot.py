"""The port's rigid-foot rollout (``models/foot.py``) and kernel K5's plain
version (``ops/cuda/rollout.py``) against ``blf_tpu``.

The inputs are ``tests/test_foot_rollout.py::make_problem``'s, drawn once on
the JAX side and handed to the port as numpy. Tolerances:

- float64, 1e-12: ``foot_dynamics``, ``foot_euler_step`` and
  ``foot_rollout(backend="torch")`` against the reference's ``"xla"`` path,
  and K5's plain version against the same path (the same products in
  another order; the rollout is damped, rounding does not grow);
- float32, 2e-5 on every field: the plain version against the Pallas kernel
  in interpret mode, the reference's own tolerance between its two paths
  (the kernel's torque takes ``e1 x (e1 x w)`` where the XLA path takes a
  skew product; the orders differ).

The physics checks of ``tests/test_foot_rollout.py`` and the wrapper's
operand handling are in ``tests/test_torch_foot_physics.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.models import foot as jfoot
from blf_tpu_torch.convert import (contact_params_from_numpy, foot_params_from_numpy,
                                   foot_state_from_numpy, foot_state_to_numpy)
from blf_tpu_torch.models.foot import foot_dynamics, foot_euler_step, foot_rollout
from blf_tpu_torch.ops.cuda import rollout as rollout_kernel
from test_foot_rollout import make_problem
from test_torch_wbc_loop import run_reference

torch.set_num_threads(1)

F64 = dict(rtol=1e-12, atol=1e-12)
F32_ATOL = 2e-5
DT = 1e-3


def port_problem(B, dtype, seed=0, per_lane=False):
    """``make_problem``'s inputs on both sides: ``(jax_args, torch_args)``,
    each ``(cparams, fparams, state, null_position, null_rotation)``; with
    ``per_lane``, (B, 1) coefficients drawn as the reference test draws them."""
    jdtype = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    cp, fp, state, p0, R0 = make_problem(B=B, seed=seed, dtype=jdtype)
    if per_lane:
        rng = np.random.default_rng(3)
        cp = cp._replace(spring_coeff=jnp.asarray(rng.uniform(1e5, 3e5, (B, 1)), jdtype),
                         damper_coeff=jnp.asarray(rng.uniform(1e3, 3e3, (B, 1)), jdtype))
    kw = dict(device="cpu", dtype=dtype)
    t = (contact_params_from_numpy({k: np.asarray(v) for k, v in cp._asdict().items()}, **kw),
         foot_params_from_numpy({k: np.asarray(v) for k, v in fp._asdict().items()}, **kw),
         foot_state_from_numpy({k: np.asarray(v) for k, v in state._asdict().items()}, **kw),
         torch.as_tensor(np.array(p0), dtype=dtype),
         torch.as_tensor(np.array(R0), dtype=dtype))
    return (cp, fp, state, p0, R0), t


def assert_state_close(out, ref, **tol):
    ref = ref._asdict() if hasattr(ref, "_asdict") else ref
    for name, value in foot_state_to_numpy(out).items():
        np.testing.assert_allclose(value, np.asarray(ref[name]), err_msg=name, **tol)


@pytest.mark.parametrize("name", ["foot_dynamics", "foot_euler_step", "foot_rollout"])
def test_torch_path_matches_the_reference_in_float64(name):
    j, t = port_problem(16, torch.float64)
    if name == "foot_dynamics":
        out, ref = foot_dynamics(*t), run_reference(jfoot.foot_dynamics, *j)
    elif name == "foot_euler_step":
        out, ref = foot_euler_step(*t, DT), run_reference(jfoot.foot_euler_step, *j, DT)
    else:
        out = foot_rollout(*t, DT, 150, backend="torch")
        ref = run_reference(jfoot.foot_rollout, *j, dt=DT, steps=150, backend="xla")
    assert_state_close(out, ref, **F64)


@pytest.mark.parametrize("B, steps, per_lane", [(13, 50, False), (256, 200, True)],
                         ids=["odd_batch", "per_lane_coefficients"])
def test_plain_version_matches_the_pallas_kernel(B, steps, per_lane):
    """The reference's own cases (``test_pallas_pads_odd_batches``,
    ``test_pallas_per_lane_stiffness``), every field, float32."""
    j, t = port_problem(B, torch.float32, per_lane=per_lane)
    rollout_kernel.reset_counts()
    out = foot_rollout(*t, DT, steps, backend="cuda")
    assert rollout_kernel.reference_count() == 1 and rollout_kernel.launch_count() == 0
    ref = run_reference(jfoot.foot_rollout, *j, dt=DT, steps=steps, backend="pallas")
    assert_state_close(out, ref, rtol=0, atol=F32_ATOL)


def test_plain_version_matches_foot_dynamics_in_float64():
    """K5's arithmetic, written component by component, against the einsum
    form of ``foot_dynamics`` (held to the reference's above), with per-lane
    coefficients and a per-lane null pose."""
    _, t = port_problem(64, torch.float64, seed=5, per_lane=True)
    rng = np.random.default_rng(9)
    p0 = torch.as_tensor(rng.normal(0, 1e-3, (64, 3)))
    R0 = port_problem(64, torch.float64, seed=9)[1][2].rotation
    t = t[:3] + (p0, R0)
    plain = rollout_kernel.foot_rollout_fused_reference(*t, dt=DT, steps=200)
    assert_state_close(plain, foot_rollout(*t, DT, 200, backend="torch"), **F64)
