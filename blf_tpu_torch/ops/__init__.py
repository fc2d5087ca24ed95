"""Numerical building blocks (counterpart of ``blf_tpu/ops``).

Ported: ``precision``, ``linalg`` (the unrolled small-PSD solves), ``lie``,
``integrators`` (the explicit steps), ``cuda/`` (the Hopper kernels that
replace ``blf_tpu/ops/pallas``: ``admm``, ``admm_lane``, ``linalg``'s batched
inverse). Not yet ported: ``advanceable``, the Rosenbrock integrator, and the
Pallas kernels ``linalg`` (single-right-hand-side solve) and ``rollout``.
"""
