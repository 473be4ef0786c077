"""The benchmark of the PyTorch / CUDA port (``src/repro_torch``).

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on this machine's CUDA device; see
``harness.py`` for how a cell's files are found.
"""
