"""Model-predictive control (counterpart of ``blf_tpu/mpc``).

Ported: ``qp`` (shared-operator and per-lane solvers), ``dcm``,
``wholebody``. Not yet ported: the row-sharded solve, ``stack``,
``riccati``, ``sqp``, ``dcm_planner``.
"""
