"""Optimizers as pure gradient transformations over dicts of tensors.

The port's counterpart of ``lightctr_tpu/optim/updaters.py`` (a redesign of
``LightCTR/util/gradientUpdater.h``).  Each optimizer is a
:class:`GradientTransformation` pair — ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)`` — over a dict of
tensors (nested dicts allowed), the shape of ``optax`` without ``optax``.

Conventions (as in the JAX package):
  - Updaters expect **already batch-averaged** gradients (the train steps
    mean-reduce the loss).
  - ``apply_updates`` adds the (negative) update to params, matching the
    reference's ``weight -= lr * ...``.
  - Adagrad puts eps **inside** the sqrt (gradientUpdater.h:146), which is
    why ``torch.optim.Adagrad`` (eps outside) is not used.

Ported so far: ``sgd`` and ``adagrad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

EPS = 1e-7


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


def tree_map(f, *trees):
    """``f`` over the tensors of equally-shaped (nested) dicts."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in head}
    return f(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a (nested) dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def apply_updates(params, updates):
    """params + updates (updates already carry the minus sign)."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# SGD (SimpleUpdater, gradientUpdater.h:63-96)
# ---------------------------------------------------------------------------

def sgd(learning_rate: float) -> GradientTransformation:
    def init_fn(params):
        return EmptyState()

    def update_fn(grads, state, params=None):
        return tree_map(lambda g: -learning_rate * g, grads), state

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Adagrad (AdagradUpdater_Num, gradientUpdater.h:127-154)
# ---------------------------------------------------------------------------

class AdagradState(NamedTuple):
    accum: dict


def adagrad(learning_rate: float, eps: float = EPS) -> GradientTransformation:
    """accum += g^2 ; w -= lr * g / sqrt(accum + eps).

    eps sits inside the sqrt, per gradientUpdater.h:146."""

    def init_fn(params):
        return AdagradState(accum=tree_map(torch.zeros_like, params))

    def update_fn(grads, state, params=None):
        accum = tree_map(lambda a, g: a + g * g, state.accum, grads)
        updates = tree_map(
            lambda g, a: -learning_rate * g * torch.rsqrt(a + eps),
            grads, accum)
        return updates, AdagradState(accum=accum)

    return GradientTransformation(init_fn, update_fn)


_REGISTRY = {
    "sgd": sgd,
    "adagrad": adagrad,
}


def get(name: str, **kw) -> GradientTransformation:
    try:
        return _REGISTRY[name](**kw)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(_REGISTRY)} (the rest of the JAX "
                         "package's optimizers are not ported yet)")
