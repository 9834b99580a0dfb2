"""Native (C++) runtime components, built on demand with g++.

A copy of ``lightctr_tpu/native``: the wire's fp16 and varint codecs and
the PS's row Adagrad call into it.  Bindings are ctypes; ``lib()``
compiles once per source change and caches the .so beside the sources.
"""

from lightctr_tpu_torch.native.bindings import (
    available,
    parse_libffm_native,
    ShmKV,
)

__all__ = ["available", "parse_libffm_native", "ShmKV"]
