"""Utilities (counterpart of ``blf_tpu/utils``).

Ported: ``status``, ``telemetry``, ``params`` (a copy); new: ``device``.
Not yet ported: ``containers``, ``checkpoint``, ``profiling``.
"""
