"""The benchmark of ``lapis_silo_torch`` on an NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Configurations (``configs/``), traffic mixes (``traffic/``) and metric
readers (``metrics/``) are found by the names ``BENCHMARK.json`` gives. The
corpus (``corpus.py``) and the plain reference (``reference/``) belong to the
benchmark; from the port it takes only the system under test, its counters
and its kernel names.
"""
