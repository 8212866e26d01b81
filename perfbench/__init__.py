"""The benchmark of the PyTorch and CUDA port (``recommend_tpu_torch``).

``run.py`` is the entry point; ``BENCHMARK.json`` at the repository root
names the cells. Each configuration, traffic mix and per-layer metric is a
file of its own under ``configs/``, ``traffic/`` and ``metrics/``; the
yardstick (inputs, weights, operation counts, trace reduction, the plain
reference and the comparison) lives under ``yardstick/`` and
``reference/``.
"""
