"""Utilities (counterpart of ``blf_tpu/utils``).

Ported, all of it: ``status``, ``telemetry``, ``params`` (a copy),
``containers`` (with a tree flatten of its own), ``checkpoint``, and
``profiling`` (the speed-of-light accounting in Hopper's units: the H100's
ceilings, a cost model of each kernel, CUDA-event timers); new: ``device``.
"""
