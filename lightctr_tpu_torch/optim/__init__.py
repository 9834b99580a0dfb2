"""Optimizers of the port: functional transforms over dicts of tensors
(``optim.updaters``, the JAX package's registry) and the fused Adagrad
kernel (``optim.fused_adagrad``)."""

from lightctr_tpu_torch.optim.updaters import (  # noqa: F401
    AdagradState,
    GradientTransformation,
    adadelta,
    adagrad,
    adam,
    add_decayed_regularization,
    apply_updates,
    chain,
    clip_by_value,
    dcasgd,
    dcasgda,
    ftrl,
    get,
    identity,
    rmsprop,
    sgd,
)

__all__ = [
    "sgd",
    "AdagradState",
    "adagrad",
    "rmsprop",
    "adadelta",
    "adam",
    "ftrl",
    "dcasgd",
    "dcasgda",
    "clip_by_value",
    "chain",
    "identity",
    "add_decayed_regularization",
    "get",
    "apply_updates",
    "GradientTransformation",
]
