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
