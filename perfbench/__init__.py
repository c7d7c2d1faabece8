"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything here is the yardstick: input generation, op and
byte counts, the device's peaks, trace reduction and the plain reference
that decides ``correct``. It imports nothing of the JAX package, and its
``reference`` imports nothing of the port.
"""
