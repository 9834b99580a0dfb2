"""lightctr_tpu_torch — the PyTorch and CUDA port of ``lightctr_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100).  The JAX
package stays the reference; this one imports ``torch`` and never ``jax``
or ``lightctr_tpu``.  Plain tensor code is PyTorch; every Pallas kernel on
a ported path becomes a hand-written CUDA kernel (``csrc/``) with a plain
PyTorch version beside it (``ops/sparse_kernels.py``).

Ported so far: the PS-backed serving slice — ``serve`` (model, cache,
server, client) over FM, with the ``gather_rows`` kernel, on the copied
PS plane (``dist``, ``embed``), native host codecs (``native``) and
telemetry (``obs``).  Entry points take ``device=`` and default to
``"cuda"``.
"""

__version__ = "0.1.0"
