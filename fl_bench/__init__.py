"""Benchmark of the PyTorch and CUDA port (``repro_torch``): live
cross-silo FL rounds on one card. ``python fl_bench/run.py --workload
<name> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once."""
