"""The benchmark of ``lightctr_tpu_torch`` on an NVIDIA H100: its cells,
the one traffic generator, the plain references, the per-layer readers
and the comparison that decides ``correct`` (``BENCHMARK.json`` at the
repository's root names them; ``python3 -m ctrbench.run`` runs one)."""
