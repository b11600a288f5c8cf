"""The PyTorch port's benchmark: ``repro_torch`` serving under the
Archipelago scheduler on one H100.

``run.py`` runs one cell of ``BENCHMARK.json`` (a model configuration under
a traffic mix).  Everything a cell needs is found by name: the
configuration in ``configs/<name>.json``, the traffic in
``traffic/<name>.json``, each per-layer metric in ``metrics/<name>.py``,
the operation and byte counts of a model family in ``counts/<family>.py``
and its plain reference in ``reference/<family>.py``.  A later cell, mix or
metric is new files only.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; the reference imports nothing of ``repro_torch`` either.
"""
