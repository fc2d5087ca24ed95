"""The port's SO(3)/SE(3) utilities against ``blf_tpu.ops.lie``.

Float64, inputs drawn with seeded numpy and handed to both sides. Tolerance
1e-12: every function is the same closed form on both sides, a handful of
products and one trigonometric call deep.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blf_tpu.ops import lie as jlie
from blf_tpu_torch.ops import lie as tlie

# One intra-op thread: the tensors here are small, and test workers running side
# by side would each start a thread per core and slow every other worker down.
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
RNG = np.random.default_rng(0)
B = 7
VEC = RNG.normal(size=(B, 3))
VEC[0] = 0.0                      # the zero rotation
VEC[1] *= 1e-8                    # inside the small-angle branch
VEC[2] *= 2.9 / np.linalg.norm(VEC[2])   # close to pi
ROT = np.array(jlie.so3_exp(jnp.asarray(VEC)))
OMEGA = RNG.normal(size=(B, 3))
QUAT = RNG.normal(size=(B, 4))
POS = RNG.normal(size=(B, 3))
ROT2 = np.array(jlie.so3_exp(jnp.asarray(RNG.normal(size=(B, 3)))))
POS2 = RNG.normal(size=(B, 3))
DRIFTED = ROT + 1e-3 * RNG.normal(size=(B, 3, 3))      # off the manifold

CASES = {
    "skew": (lambda m, a: m.skew(a(VEC)),),
    "unskew": (lambda m, a: m.unskew(a(DRIFTED)),),
    "so3_exp": (lambda m, a: m.so3_exp(a(VEC)),),
    "so3_log": (lambda m, a: m.so3_log(a(ROT)),),
    "rotation_rate_mixed": (lambda m, a: m.rotation_rate_mixed(a(ROT), a(OMEGA)),),
    "so3_baumgarte_rate": (lambda m, a: m.so3_baumgarte_rate(a(DRIFTED), a(OMEGA), 2.5),),
    "quat_to_rot": (lambda m, a: m.quat_to_rot(a(QUAT)),),
    "rot_to_quat": (lambda m, a: m.rot_to_quat(a(ROT)),),
    "rpy_to_rot": (lambda m, a: m.rpy_to_rot(a(VEC[:, 0]), a(VEC[:, 1]), a(VEC[:, 2])),),
    "se3_compose_rot": (lambda m, a: m.se3_compose(a(ROT), a(POS), a(ROT2), a(POS2))[0],),
    "se3_compose_pos": (lambda m, a: m.se3_compose(a(ROT), a(POS), a(ROT2), a(POS2))[1],),
    "se3_apply": (lambda m, a: m.se3_apply(a(ROT), a(POS), a(POS2)),),
    "se3_inverse_rot": (lambda m, a: m.se3_inverse(a(ROT), a(POS))[0],),
    "se3_inverse_pos": (lambda m, a: m.se3_inverse(a(ROT), a(POS))[1],),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_the_reference(name):
    (fn,) = CASES[name]
    ref = np.asarray(fn(jlie, jnp.asarray))
    got = fn(tlie, torch.as_tensor)
    assert got.dtype == torch.float64 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # unbatched: the first sample alone
    one = fn(tlie, lambda x: torch.as_tensor(x)[0] if np.ndim(x) else torch.as_tensor(x))
    np.testing.assert_allclose(one.numpy(), ref[0], **TOL)


def test_every_public_function_is_compared():
    compared = {n.split("_rot")[0].split("_pos")[0] if n.startswith("se3") else n
                for n in CASES}
    assert compared == set(tlie.__all__) == set(jlie.__all__)


def test_rotation_round_trips():
    R = torch.as_tensor(ROT)
    np.testing.assert_allclose(tlie.so3_exp(tlie.so3_log(R)).numpy(), ROT, atol=1e-9)
    np.testing.assert_allclose(tlie.quat_to_rot(tlie.rot_to_quat(R)).numpy(), ROT, atol=1e-12)
    assert bool((tlie.rot_to_quat(R)[:, 0] >= 0).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_jvp_through_so3_exp_is_finite_at_angle_zero(dtype):
    """Forward kinematics differentiates through ``so3_exp`` for every
    revolute joint, at angle 0 too: the untaken branch must not leak NaN."""
    omega = torch.zeros((4, 3), dtype=dtype)
    omega[1] = torch.tensor([1e-9, 0.0, 0.0])
    omega[2] = torch.tensor([0.3, -0.2, 0.1])
    tangent = torch.as_tensor(RNG.normal(size=(4, 3)), dtype=dtype)
    out, dout = torch.func.jvp(tlie.so3_exp, (omega,), (tangent,))
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(dout).all())
    # at angle 0 the derivative is skew(tangent), as the reference's is
    np.testing.assert_allclose(dout[0].numpy(), tlie.skew(tangent[0]).numpy(), atol=1e-6)
    _, ref = jax.jvp(jlie.so3_exp, (jnp.asarray(omega.double().numpy()),),
                     (jnp.asarray(tangent.double().numpy()),))
    np.testing.assert_allclose(dout.double().numpy(), np.asarray(ref),
                               atol=1e-12 if dtype == torch.float64 else 1e-6)
