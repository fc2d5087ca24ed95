"""Utilities (counterpart of ``blf_tpu/utils``).

Ported: ``status``, ``telemetry``, ``params`` (a copy), ``containers``
(with a tree flatten of its own), ``checkpoint``; new: ``device``. Not
ported on purpose: ``profiling`` (TPU rooflines; ROADMAP.md, "Do not port").
"""
