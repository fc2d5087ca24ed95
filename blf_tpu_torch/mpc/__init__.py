"""Model-predictive control (counterpart of ``blf_tpu/mpc``).

Ported: ``qp`` (shared-operator and per-lane solvers), ``dcm``,
``wholebody``, ``stack``, ``riccati``, ``sqp`` (the batched nonlinear
trajectory optimizer), ``dcm_planner`` (the time-varying DCM planner). Not
yet ported: the row-sharded QP solve and ``riccati.solve_lqr_sharded``
(multi-device, ROADMAP.md 4.5).
"""
