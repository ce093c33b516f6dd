"""The benchmark of ``audiosourcesep_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. What belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes, its source and what was
  assumed; its ``arch`` names ``arch/<arch>.py`` (how the program builds
  it) and ``reference/<arch>.py`` (its plain float32 reference);
* ``traffic/<traffic>.json``: the separation job (frames, dtype, chunking,
  routing, the mixture's draw), read by :mod:`portbench.traffic`;
* ``workloads/<cell>.json``: what decides ``correct`` in that cell and the
  readings its limits were set from;
* ``metrics/<metric>.py``: one per-layer metric's reader.

Nothing here imports JAX or the JAX package ``audiosourcesep_tpu``;
``reference/`` imports nothing of the port either.
"""
