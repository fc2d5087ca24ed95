"""Estimators (counterpart of ``blf_tpu/estimators``).

Ported: ``rls``. Not yet ported: ``rls_parallel``, ``wrench_observer``.
"""
