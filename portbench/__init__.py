"""portbench: the benchmark of versatilefilmgrain_tpu_torch on one card.

Run one cell once, from the root of a checkout:

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix,
driver and per-layer metrics are files of their own under this folder,
found by name (``run.py``).  Importing this package imports nothing else.
"""
