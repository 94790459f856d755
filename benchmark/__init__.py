"""The benchmark of ``lapis_silo_torch`` on an NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Configurations (``configs/``), traffic mixes (``traffic/``) and metric
readers (``metrics/``) are found by the names ``BENCHMARK.json`` gives, and
each configuration names its corpus module (``"corpus"``: ``corpus.py`` for
both today), which draws the corpus, its requests and its plain reference
(``reference/``); all belong to the benchmark. From the port it takes only
the system under test, its spans, its counters and its kernel names.
"""
