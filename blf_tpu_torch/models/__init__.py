"""Models (counterpart of ``blf_tpu/models``).

Ported: ``lipm``. Not yet ported: ``systems``, ``contact``, ``foot``,
``kinematics``, ``rigid_body``, ``robots``, ``urdf``.
"""
