"""Model-predictive control (counterpart of ``blf_tpu/mpc``).

Ported: the shared-operator path of ``qp`` and ``dcm``. Not yet ported:
``solve_qp``, ``solve_qp_lanes``, the row-sharded solve, ``wholebody``,
``stack``, ``riccati``, ``sqp``, ``dcm_planner``.
"""
