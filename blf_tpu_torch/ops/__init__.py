"""Numerical building blocks (counterpart of ``blf_tpu/ops``).

Ported: ``precision``, ``linalg`` (the unrolled small-PSD solves), ``cuda/``
(the Hopper kernels that replace ``blf_tpu/ops/pallas``). Not yet ported:
``lie``, ``integrators``, ``advanceable``, and the Pallas kernels
``admm_lane``, ``linalg`` (batch-minor Cholesky) and ``rollout``.
"""
