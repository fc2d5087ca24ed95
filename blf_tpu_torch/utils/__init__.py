"""Utilities (counterpart of ``blf_tpu/utils``).

Ported: ``status``, ``telemetry``; new: ``device``. Not yet ported:
``params``, ``containers``, ``checkpoint``, ``profiling``.
"""
