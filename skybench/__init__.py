"""The benchmark of the PyTorch and CUDA skyline engine.

``python3 -m skybench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Configurations, traffic mixes and metric
readers are files of their own (``configs/``, ``traffic/``, ``metrics/``),
found by the names ``BENCHMARK.json`` gives them.
"""
