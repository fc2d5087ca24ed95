"""Models (counterpart of ``blf_tpu/models``).

Ported: ``lipm``, ``kinematics``, ``robots``, ``rigid_body``, ``contact``
(all but ``params_from_handler``). Not yet ported: ``systems``, ``foot``,
``urdf``.
"""
