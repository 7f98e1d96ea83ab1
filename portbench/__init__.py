"""The port's benchmark: served MI-discovery queries over sketch lakes.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card.
Configurations (``configs/*.json``), traffic mixes (``traffic/*.json``),
lake generators (``lakes/``), traffic drivers (``drivers/``) and
per-layer metric readers (``metrics/``) are files found by name.
"""
