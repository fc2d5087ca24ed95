"""Numerical building blocks (counterpart of ``blf_tpu/ops``).

Ported: ``precision``, ``linalg`` (the unrolled small-PSD solves), ``lie``,
``integrators`` (the explicit steps and the stiff ROS2-W integrator),
``cuda/`` (the Hopper kernels that replace ``blf_tpu/ops/pallas``: ``admm``,
``admm_lane``, ``linalg``'s batched inverse and solve, ``rollout``),
``advanceable``; new: ``scan`` (the log-depth associative scan that JAX has
built in).
"""
