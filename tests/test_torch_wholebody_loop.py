"""Slice 2a as a whole on the 23-DoF humanoid, against ``blf_tpu``.

Five 100 Hz ticks of ``wbc_balance_step`` on four lanes of ``standing_fleet``
(QP build of n = 64 unknowns and m = 86 rows, warm-started solve, RK4 plant)
against the same loop written with ``blf_tpu`` (``jax_loop`` of
``tests/test_torch_wbc_loop.py``), float64, from the same seeded inputs. State
and torques within 1e-6: a tick's QP is solved to eps = 1e-5 on both sides
from iterates that agree to ~1e-9, and the plant integrates 10 ms of the
difference. Here the loop runs ``backend="torch"`` against the reference's
``"xla"``; ``tests/test_torch_wbc_loop.py`` runs ``backend="cuda"`` against the
reference's Pallas kernels (in interpret mode those take minutes to compile
at n = 64, so that file uses a small biped).
"""

import numpy as np
import torch

from blf_tpu.models.robots import make_humanoid_23dof as jax_humanoid
from blf_tpu_torch.convert import floating_base_state_to_numpy
from blf_tpu_torch.models.kinematics import forward_kinematics
from blf_tpu_torch.models.rigid_body import com_position
from blf_tpu_torch.ops.cuda import admm_lane, linalg
from blf_tpu_torch.problems import standing_fleet
from test_torch_wbc_loop import jax_loop_start, torch_loop

# One intra-op thread: the tensors here are a few lanes wide, so more threads
# gain nothing, and test workers running side by side would each start a
# thread per core and slow every other worker down.
torch.set_num_threads(1)

B, TICKS, EPS = 4, 5, 1e-5


def test_five_ticks_of_the_balance_loop_match_the_reference():
    fleet = standing_fleet(B, seed=0, device="cpu", dtype=torch.float64)
    ref = jax_loop_start(jax_humanoid(), fleet, TICKS, EPS, backend="xla")
    admm_lane.reset_counts()
    linalg.reset_counts()
    out = torch_loop(fleet, TICKS, EPS, backend="torch")
    ref = ref()
    for k, ((state, sol, _), (ref_state, ref_sol)) in enumerate(zip(out, ref)):
        for name, val in floating_base_state_to_numpy(state).items():
            np.testing.assert_allclose(val, np.asarray(getattr(ref_state, name)),
                                       atol=1e-6, rtol=0, err_msg=f"tick {k + 1}: {name}")
        np.testing.assert_allclose(sol.torques.numpy(), np.asarray(ref_sol.x[:, 41:]),
                                   atol=1e-6, rtol=0, err_msg=f"tick {k + 1}: torques")
        np.testing.assert_array_equal(sol.qp.converged.numpy(),
                                      np.asarray(ref_sol.converged))
        assert bool(sol.qp.converged.all()), f"tick {k + 1}"
    # this backend reaches neither kernel wrapper
    assert admm_lane.reference_count() == linalg.reference_count() == 0
    # what the reference's own closed-loop test asserts, after these ticks
    poses = forward_kinematics(fleet.tree, state.base_position,
                               state.base_rotation, state.joint_positions)
    com = com_position(fleet.tree, poses)
    assert float((com - fleet.com_ref).abs().max()) < 0.02
    assert float(state.base_twist.abs().max()) < 0.5
    assert float(state.base_rotation[:, 2, 2].min()) > 0.99
