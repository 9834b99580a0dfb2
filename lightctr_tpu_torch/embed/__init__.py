"""Host-side parameter-server stores, copied from ``lightctr_tpu/embed``."""

from lightctr_tpu_torch.embed.async_ps import AsyncParamServer

__all__ = ["AsyncParamServer"]
