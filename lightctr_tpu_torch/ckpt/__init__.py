from lightctr_tpu_torch.ckpt.checkpoint import (Checkpointer, latest_step,
                                                restore, save)

__all__ = ["save", "restore", "latest_step", "Checkpointer"]
