"""Models (counterpart of ``blf_tpu/models``).

Ported: ``lipm``, ``kinematics``, ``robots``, ``rigid_body`` (all but
``make_contact_dynamics``). Not yet ported: ``systems``, ``contact``,
``foot``, ``urdf``.
"""
