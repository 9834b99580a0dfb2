"""Command-line tools of the port: the kernel benches
(``python -m lightctr_tpu_torch.tools.sparse_kernel_bench``,
``python -m lightctr_tpu_torch.tools.kernel_bench``)."""
