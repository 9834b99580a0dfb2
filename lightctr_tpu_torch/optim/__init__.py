"""Optimizers of the port: functional ``sgd``/``adagrad`` transforms and
the fused Adagrad kernel (``optim.fused_adagrad``)."""

from lightctr_tpu_torch.optim.updaters import (  # noqa: F401
    AdagradState,
    GradientTransformation,
    adagrad,
    apply_updates,
    get,
    sgd,
)
