"""Command-line tools of the port: the kernel benches
(``python -m lightctr_tpu_torch.tools.sparse_kernel_bench``,
``python -m lightctr_tpu_torch.tools.kernel_bench``), the A/B of
checkouts' ring call and data-parallel steps
(``python -m lightctr_tpu_torch.tools.path_ab``) and of their row,
touched-row and quantize kernels
(``python -m lightctr_tpu_torch.tools.kernel_ab``), both on ``ab_roots``,
the stress of the launcher's rendezvous
(``python -m lightctr_tpu_torch.tools.world_stress``) and the shard-cache
compiler (``python -m lightctr_tpu_torch.tools.ingest_compile``)."""
