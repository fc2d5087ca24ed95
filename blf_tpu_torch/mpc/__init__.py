"""Model-predictive control (counterpart of ``blf_tpu/mpc``).

Everything of it is ported: ``qp`` (shared-operator and per-lane solvers,
and the row-sharded shared-operator solve), ``dcm``, ``wholebody``,
``stack``, ``riccati`` (with the horizon-sharded LQR), ``sqp`` (the batched
nonlinear trajectory optimizer), ``dcm_planner`` (the time-varying DCM
planner).
"""
