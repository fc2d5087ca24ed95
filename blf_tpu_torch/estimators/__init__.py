"""Estimators (counterpart of ``blf_tpu/estimators``).

Ported: ``rls``, ``wrench_observer``. Not yet ported: ``rls_parallel``.
"""
