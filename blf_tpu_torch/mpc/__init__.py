"""Model-predictive control (counterpart of ``blf_tpu/mpc``).

Ported: ``qp`` (shared-operator and per-lane solvers), ``dcm``,
``wholebody``, ``stack``. Not yet ported: the row-sharded solve,
``riccati``, ``sqp``, ``dcm_planner``.
"""
