"""The benchmark of the PyTorch and CUDA port (``predictionio_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on and prints one JSON result line last. Everything that belongs
to one cell is data found by name: a configuration in ``configs/``, a
traffic mix in ``traffic/`` (which names its loop in ``loops/``), the
limits of its correctness check in ``limits/``, a per-layer metric's
reader in ``metrics/``, a kernel's operation and byte counts in
``roofline/``, and the plain references in ``reference/``.
"""
