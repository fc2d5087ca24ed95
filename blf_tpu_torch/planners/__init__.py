"""Planners (counterpart of ``blf_tpu/planners``).

Ported: ``variables``. Not yet ported: ``contacts``, ``convex_hull``, ``gait``.
"""
