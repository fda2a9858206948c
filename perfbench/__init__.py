"""The benchmark of ``repro_torch`` on one NVIDIA GPU.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
per-cell limit or metric sits in a file of its own, found by its name:

- ``configs/<config>.json``: a graph's generator and sizes;
- ``mixes/<traffic>.json``: the program, its system config and the loop;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader ``read(record) -> float | None``;
- ``reference/<program>.py``: the plain torch solver and comparison.

Nothing here imports JAX or the JAX package ``repro``; the reference
imports nothing of ``repro_torch``.
"""
