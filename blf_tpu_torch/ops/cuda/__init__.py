"""Hand-written CUDA kernels for Hopper (counterpart of ``blf_tpu/ops/pallas``).

Ported, all five: ``admm`` (``_stage_kernel_t``), ``admm_lane``
(``_lane_kernel``), ``linalg`` (``_inverse_kernel`` and ``_solve_kernel``,
sharing one factorization), ``rollout`` (``_rollout_kernel``).
"""
