"""Planners (counterpart of ``blf_tpu/planners``).

Ported: ``variables``, ``contacts``, ``convex_hull``, ``gait``: everything of
the reference subpackage.
"""
