"""Thin autograd DAG builder, API parity with ``LightCTR/dag``.

The port's counterpart of ``lightctr_tpu/graph/dag.py``.  The reference
hand-builds a dataflow graph of nodes with futures/promises, CAS-guarded
single execution and hand-written VJPs per op (``dag/node_abst.h:57-231``,
``dag/operator/*.h``), executed on its thread pool.  Here autograd gives
the VJPs and the device runs the ops in order; what remains is the
builder API: declare sources, trainables and op nodes, and get a forward
function and a training step (dag_pipeline.h:28-37 ``addDirectedFlow`` /
``addAutogradFlow``).  The reference's -DDAG demo, sigma(w*x+b) with
logistic loss (``main.cpp:80-116``):

    g = Graph(device="cuda")
    x = g.add_node(source("x"))                       # feeds [batch, 4]
    w = g.add_node(trainable("w", init=torch.ones(4)))
    b = g.add_node(trainable("b", init=torch.zeros(())))
    wx = g.add_node(matmul(x, w))                     # [batch, 4] @ [4]
    z = g.add_node(add(wx, b))
    p = g.add_node(activation(z, "sigmoid"))
    loss = g.add_node(logistic_loss_node(p, label_name="y"))
    step, opt_state = g.compile_train_step(loss, optim.sgd(0.1))
    params = g.init_params()
    params, opt_state, loss_value = step(params, opt_state, feeds)

The compiled functions are plain Python over tensors on the graph's
device (``"cuda"`` by default; it raises without CUDA unless ``"cpu"`` is
passed): the JAX package jits them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from lightctr_tpu_torch import optim as optim_lib
from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.ops import activations as act_lib
from lightctr_tpu_torch.ops import losses as loss_lib


@dataclasses.dataclass
class Node:
    kind: str                       # source | trainable | op
    name: str
    inputs: List[int]
    fn: Optional[Callable] = None   # op nodes: fn(*input_values) -> value
    init: Optional[torch.Tensor] = None  # trainable nodes


def source(name: str) -> Node:
    """Graph input (SourceNode, dag/source_node.h)."""
    return Node(kind="source", name=name, inputs=[])


def trainable(name: str, init) -> Node:
    """Learnable leaf with its own updater state
    (TrainableNode, dag/source_node.h:63-77)."""
    return Node(kind="trainable", name=name, inputs=[],
                init=torch.as_tensor(init))


def add(a: int, b: int) -> Node:
    """AddOp (dag/operator/add_op.h)."""
    return Node(kind="op", name="add", inputs=[a, b], fn=lambda x, y: x + y)


def multiply(a: int, b: int) -> Node:
    """MultiplyOp: elementwise."""
    return Node(kind="op", name="multiply", inputs=[a, b],
                fn=lambda x, y: x * y)


def matmul(a: int, b: int) -> Node:
    """MatmulOp (dag/operator/matmul_op.h: a dot product in the
    reference)."""
    return Node(kind="op", name="matmul", inputs=[a, b],
                fn=lambda x, y: x @ y)


def activation(a: int, name: str) -> Node:
    """ActivationsOp<Act> (dag/operator/activations_op.h)."""
    fn = act_lib.get(name)
    return Node(kind="op", name=f"act:{name}", inputs=[a], fn=fn)


def aggregate(inputs: List[int], fn: Callable,
              name: str = "aggregate") -> Node:
    """N-in/M-out op (``AggregateNode``, dag/aggregate_node.h:15-29):
    ``fn`` takes the N input tensors and returns a TUPLE of M tensors.  The
    node's value is the tuple; consume single outputs through
    :func:`project`.  Single execution holds: the tuple is computed once
    and fanned out to every consumer (node_abst.h:103-107)."""
    return Node(kind="op", name=f"agg:{name}", inputs=list(inputs), fn=fn)


def project(a: int, index: int) -> Node:
    """Select output ``index`` of an aggregate node."""
    return Node(
        kind="op", name=f"project:{index}", inputs=[a],
        fn=lambda t, _i=index: t[_i],
    )


def logistic_loss_node(pred: int, label_name: str = "label") -> Node:
    """LossOp<Logistic> terminus (dag/operator/loss_op.h:29-50).  The
    node's input is a *probability* (the reference's sigmoid -> loss
    pairing); the loss is the clamped BCE's mean."""
    node = Node(kind="op", name="loss:logistic", inputs=[pred], fn=None)
    node.fn = ("__loss__", label_name)  # type: ignore[assignment]
    return node


class Graph:
    """Builds a node list; compiles it to forward and train-step functions
    (the runFlow equivalents, terminus_node.h:23-26 / source_node.h:24) on
    ``device``."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.nodes: List[Node] = []

    def add_node(self, node: Node) -> int:
        self.nodes.append(node)
        return len(self.nodes) - 1

    # -- compilation -------------------------------------------------------

    def init_params(self) -> Dict[str, torch.Tensor]:
        """Fresh copies of the trainables' inits on the graph's device."""
        return {n.name: n.init.to(self.device, copy=True)
                for n in self.nodes if n.kind == "trainable"}

    def _feeds(self, feeds) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in feeds.items()}

    def _eval(self, out_id: int, params, feeds):
        values: Dict[int, torch.Tensor] = {}

        def ev(i: int):
            if i in values:
                return values[i]  # cached single execution (node_abst.h:66)
            n = self.nodes[i]
            if n.kind == "source":
                v = feeds[n.name]
            elif n.kind == "trainable":
                v = params[n.name]
            else:
                if isinstance(n.fn, tuple) and n.fn[0] == "__loss__":
                    pred = ev(n.inputs[0])
                    v = loss_lib.bce_on_probs(pred, feeds[n.fn[1]],
                                              reduction="mean")
                else:
                    v = n.fn(*[ev(j) for j in n.inputs])
            values[i] = v
            return v

        return ev(out_id)

    def compile_forward(self, out_id: int) -> Callable:
        """(params, feeds) -> value of node ``out_id``."""

        def forward(params, feeds):
            with torch.no_grad():
                return self._eval(out_id, params, self._feeds(feeds))

        return forward

    def compile_train_step(
        self, loss_id: int,
        optimizer: Optional[optim_lib.GradientTransformation] = None,
    ):
        """Returns (step, opt_state0): step(params, opt_state, feeds) ->
        (params, opt_state, loss), forward, backward (autograd) and the
        per-trainable update of the optimizer transform (default
        ``optim.sgd(0.1)``), replacing the promise/future dance of
        node_abst.h:57-231.  ``loss`` is a 0-d tensor on the device."""
        tx = optimizer or optim_lib.sgd(0.1)
        opt_state0 = tx.init(self.init_params())

        def step(params, opt_state, feeds):
            feeds = self._feeds(feeds)
            leaves = {k: v.detach().requires_grad_() for k, v in
                      params.items()}
            loss = self._eval(loss_id, leaves, feeds)
            loss.backward()
            grads = {k: (v.grad if v.grad is not None
                         else torch.zeros_like(v)) for k, v in leaves.items()}
            with torch.no_grad():
                updates, opt_state2 = tx.update(grads, opt_state, params)
                params2 = optim_lib.apply_updates(params, updates)
            return params2, opt_state2, loss.detach()

        return step, opt_state0
