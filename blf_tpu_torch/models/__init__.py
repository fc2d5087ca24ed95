"""Models (counterpart of ``blf_tpu/models``).

Ported: ``lipm``, ``kinematics``, ``robots``, ``rigid_body``, ``contact``,
``systems``, ``foot``, ``urdf``.
"""
