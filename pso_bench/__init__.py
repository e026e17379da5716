"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of cuPSO.

``python3 pso_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything that belongs to one configuration, traffic mix,
per-layer metric, kernel cost, objective, variant's reference or compared
number sits in a file of its own under ``configs/``, ``traffic/``,
``metrics/``, ``costs/``, ``objectives/``, ``variants/``, ``numbers/`` and
``limits/``, found by the name ``BENCHMARK.json`` or a cell's files give
it.
"""
