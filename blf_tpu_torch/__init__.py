"""blf_tpu_torch: the PyTorch/CUDA port of ``blf_tpu`` for NVIDIA Hopper.

The JAX package ``blf_tpu`` is the reference and stays as it is; this package
grows beside it, one slice at a time, with the same subpackage names
(``ops/ models/ estimators/ planners/ mpc/ parallel/ utils/``) so that every module has
an obvious counterpart. It imports ``torch``, numpy and the standard library,
never ``jax`` and nothing of ``blf_tpu``.

Slice 1: the warm-started push-recovery fleet tick,
:func:`blf_tpu_torch.parallel.sweep.make_fleet_step`, with the fused ADMM
stage as a hand-written CUDA kernel (``csrc/admm_stage.cu``).

Slice 2a: the 100 Hz whole-body-control loop of the 23-DoF humanoid over a
fleet, :func:`blf_tpu_torch.problems.wbc_balance_step` (rigid-body engine,
whole-body QP, per-lane ADMM, RK4 plant), with the per-lane ADMM stage and
the batched Cholesky inverse as hand-written CUDA kernels
(``csrc/admm_lane.cu``, ``csrc/chol_lane.cu``).

Slice 2b: the whole control stack over a push-recovery fleet of the humanoid,
:func:`blf_tpu_torch.mpc.stack.make_fleet_stack_step` (DCM-MPC, whole-body
QP, contact model, stiff ROS2-W plant, momentum observer and RLS), with the
batched SPD solve of the wrench attribution as a hand-written CUDA kernel
(``csrc/chol_solve.cu``).

Slice 3: BASELINE config 2, the spring-damper foot rollout over a fleet,
:func:`blf_tpu_torch.models.foot.foot_rollout`, with the whole horizon in
one hand-written CUDA kernel (``csrc/foot_rollout.cu``), and contact
identification on it, :func:`blf_tpu_torch.problems.identify_contacts`
(RLS in three forms: sequential, one reduction, a log-depth scan).

Slice 4 (first part): BASELINE config 1 closed out
(:func:`blf_tpu_torch.models.lipm.dcm_reference_trajectory`) and config 3,
the full gait, :func:`blf_tpu_torch.planners.gait.plan_gait` (contact
timeline, batched convex hulls, the shared DCM QP), whose shared QP at
(960, 384) runs K1's exact f32 stage on a kernel that streams the operator
from L2 (``csrc/admm_stage_l2.cu``). Beside it, not called by it, the native
host runtime :mod:`blf_tpu_torch.native`: a standalone batch API (schedule
lowering and support polygons in C++) for sweeps set up on the host.

Slice 4 (second part): the time-varying DCM planner,
:func:`blf_tpu_torch.mpc.dcm_planner.plan_time_varying_dcm_batch`, on the
batched SQP (:mod:`blf_tpu_torch.mpc.sqp`) and the Riccati solvers
(:mod:`blf_tpu_torch.mpc.riccati`), over a fleet of scenarios on torch ops
(no Pallas kernel carries it in the reference); and the host utilities:
URDF loading, the ``Advanceable`` step protocol, container trees and
checkpoints that either package reads.

Rules that hold everywhere in the package:

- **Device.** ``device=None`` means ``torch.device("cuda")``; without CUDA the
  entry point raises. Nothing carries on on the CPU because it found no GPU;
  the CPU is used only when the caller passes ``device="cpu"``.
- **Precision.** Solver math is full float32 (TF32 off), see
  :mod:`blf_tpu_torch.ops.precision`.
- **Kernels** are built by ``nvcc`` at first launch, never at import.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
