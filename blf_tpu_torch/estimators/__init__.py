"""Estimators (counterpart of ``blf_tpu/estimators``).

Ported: ``rls``, ``wrench_observer``, ``rls_parallel`` (all but
``rls_parallel_sharded``, which waits for the multi-device slice).
"""
