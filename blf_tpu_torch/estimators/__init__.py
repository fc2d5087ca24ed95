"""Estimators (counterpart of ``blf_tpu/estimators``).

Everything of it is ported: ``rls``, ``wrench_observer``, ``rls_parallel``
(with the stream sharded over a mesh axis, ``rls_parallel_sharded``).
"""
