"""Hand-written CUDA kernels for Hopper (counterpart of ``blf_tpu/ops/pallas``).

Ported: ``admm`` (``_stage_kernel_t``). Not yet ported: ``admm_lane``
(``_lane_kernel``), ``linalg`` (``_inverse_kernel``, ``_solve_kernel``),
``rollout`` (``_rollout_kernel``).
"""
