"""joinbench: the benchmark of ``htm_hashjoin_tpu_torch``, the PyTorch and
CUDA port of the join engine.

``run.py`` runs one cell of ``BENCHMARK.json`` on the card.  Everything it
reads is found by name: ``configs/<config>.json``, ``traffic/<mix>.json``,
``entries/<entry>.py`` (the join step a configuration's cells time),
``gen/<generator>.py`` and ``metrics/<metric>.py``.
"""
