"""The benchmark of ``blf_tpu_torch`` on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Each
configuration (``configs/``), traffic mix (``traffic/``), per-layer metric
reader (``metrics/``) and set of comparison limits (``limits/``) is a file of
its own, found by the name ``BENCHMARK.json`` gives it. ``paths/`` holds one
driver per program path that a configuration names. ``reference/`` is the
plain reference that decides ``correct``; it imports nothing of the program.
"""
