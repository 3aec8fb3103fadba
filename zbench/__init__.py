"""The benchmark of gochugaru_tpu_torch on one NVIDIA card.

``python -m zbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line.  Everything
that belongs to one configuration, traffic mix or metric is found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``,
and the generator, plain reference and traffic kind those files name
(``generators/``, ``reference/``, ``kinds/``).
"""
