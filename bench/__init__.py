"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix or metric lives in a file of
its own under this directory and is found by its name; the harness
(``harness.py``) names none of them.
"""
