"""The autograd DAG builder (``graph.dag``), the port's copy of
``lightctr_tpu/graph``."""

from lightctr_tpu_torch.graph.dag import (
    Graph,
    source,
    trainable,
    add,
    multiply,
    matmul,
    activation,
    logistic_loss_node,
)

__all__ = [
    "Graph",
    "source",
    "trainable",
    "add",
    "multiply",
    "matmul",
    "activation",
    "logistic_loss_node",
]
