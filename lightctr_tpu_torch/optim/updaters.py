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
  - eps placement follows the reference where it differs from the
    textbook: Adagrad puts eps **inside** the sqrt (gradientUpdater.h:146),
    which is why ``torch.optim.Adagrad`` (eps outside) is not used; Adam
    adds eps outside sqrt(v) (momentumUpdater.h:204).

Dense transforms update unconditionally (the reference skips ``g == 0``
entries, an artifact of dense arrays holding sparse gradients); the
touched-row semantics live in ``embed.table`` and the sparse trainer.
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


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _rebuild(like, items):
    """A dict, tuple, list or NamedTuple of ``like``'s type over ``items``."""
    if _is_namedtuple(like):
        return type(like)(*items)
    return type(like)(items)


def tree_map(f, *trees):
    """``f`` over the tensors of equally-shaped trees: dicts, tuples,
    lists and NamedTuples of tensors, nested."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: tree_map(f, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (tuple, list)):
        return _rebuild(head, [tree_map(f, *xs) for xs in zip(*trees)])
    return f(*trees)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in key (or field) order."""
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
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


# ---------------------------------------------------------------------------
# RMSprop (RMSpropUpdater_Num, gradientUpdater.h:201-233)
# ---------------------------------------------------------------------------

class RMSpropState(NamedTuple):
    accum: dict


def rmsprop(learning_rate: float, ema_rate: float = 0.9,
            eps: float = EPS) -> GradientTransformation:
    """accum = q*accum + (1-q)*g^2 ; w -= lr * g / sqrt(accum + eps)
    (the reference's ``g * sqrt(1/(accum+eps))``,
    gradientUpdater.h:222-226)."""

    def init_fn(params):
        return RMSpropState(accum=tree_map(torch.zeros_like, params))

    def update_fn(grads, state, params=None):
        accum = tree_map(lambda a, g: a * ema_rate + (1.0 - ema_rate) * g * g,
                         state.accum, grads)
        updates = tree_map(
            lambda g, a: -learning_rate * g * torch.rsqrt(a + eps),
            grads, accum)
        return updates, RMSpropState(accum=accum)

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Adadelta (AdadeltaUpdater_Num, momentumUpdater.h:60-110)
# ---------------------------------------------------------------------------

class AdadeltaState(NamedTuple):
    accum_g: dict   # EMA of g^2
    accum_dx: dict  # EMA of update^2


def adadelta(momentum: float = 0.9, eps: float = EPS
             ) -> GradientTransformation:
    """dx = g * sqrt(accum_dx + eps) / sqrt(accum_g + eps); no learning
    rate (momentumUpdater.h:86-103: the reference's Adadelta ignores
    __global_learning_rate, decaying with __global_momentum)."""

    def init_fn(params):
        return AdadeltaState(accum_g=tree_map(torch.zeros_like, params),
                             accum_dx=tree_map(torch.zeros_like, params))

    def update_fn(grads, state, params=None):
        accum_g = tree_map(
            lambda a, g: a * momentum + (1.0 - momentum) * g * g,
            state.accum_g, grads)
        dx = tree_map(
            lambda g, ag, ad: g * torch.sqrt(ad + eps) * torch.rsqrt(ag + eps),
            grads, accum_g, state.accum_dx)
        accum_dx = tree_map(
            lambda a, d: a * momentum + (1.0 - momentum) * d * d,
            state.accum_dx, dx)
        return (tree_map(lambda d: -d, dx),
                AdadeltaState(accum_g=accum_g, accum_dx=accum_dx))

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Adam (AdamUpdater_Num, momentumUpdater.h:176-215)
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: torch.Tensor  # int32 scalar, on the params' device
    mu: dict
    nu: dict


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = EPS) -> GradientTransformation:
    """m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g^2 ;
    w -= lr * correction * m / (sqrt(v) + eps), with the reference's joint
    warm-up correction ``sqrt(1-b2^t)/(1-b1^t)`` (momentumUpdater.h:190-192)
    applied to the whole step rather than per moment."""

    def init_fn(params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return AdamState(count=torch.zeros((), dtype=torch.int32,
                                           device=device),
                         mu=tree_map(torch.zeros_like, params),
                         nu=tree_map(torch.zeros_like, params))

    def update_fn(grads, state, params=None):
        count = state.count + 1
        t = count.to(torch.float32)
        correction = torch.sqrt(1.0 - torch.pow(b2, t)) / (
            1.0 - torch.pow(b1, t))
        mu = tree_map(lambda m, g: m * b1 + (1.0 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: v * b2 + (1.0 - b2) * g * g,
                      state.nu, grads)
        updates = tree_map(
            lambda m, v: -learning_rate * correction * m / (torch.sqrt(v)
                                                            + eps),
            mu, nu)
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# FTRL-proximal (FTRLUpdater, gradientUpdater.h:235-278) — online learning
# ---------------------------------------------------------------------------

class FTRLState(NamedTuple):
    z: dict
    n: dict


def _unzip(like, tree, width: int):
    """``tree`` holds a ``width``-tuple at each leaf of ``like``'s
    structure -> ``width`` trees of that structure (``tree_transpose``)."""
    if isinstance(like, dict):
        parts = {k: _unzip(like[k], tree[k], width) for k in like}
        return tuple({k: p[i] for k, p in parts.items()}
                     for i in range(width))
    if isinstance(like, (tuple, list)):
        parts = [_unzip(a, b, width) for a, b in zip(like, tree)]
        return tuple(_rebuild(like, [p[i] for p in parts])
                     for i in range(width))
    return tree


def _require_params(name: str, params) -> None:
    if params is None:
        raise ValueError(f"{name} requires params")


def ftrl(alpha: float = 0.15, beta: float = 1.0, lambda1: float = 1.0,
         lambda2: float = 1.0) -> GradientTransformation:
    """FTRL-proximal with L1 sparsification.  Defaults are the reference's
    constants (gradientUpdater.h:276).  It sets the weight *directly*
    (closed-form argmin), so ``update`` returns ``w_new - w`` as the
    update.  Requires ``params``."""

    def init_fn(params):
        return FTRLState(z=tree_map(torch.zeros_like, params),
                         n=tree_map(torch.zeros_like, params))

    def update_fn(grads, state, params=None):
        _require_params("ftrl", params)

        def per_leaf(g, z, n, w):
            g2 = g * g
            sigma = (torch.sqrt(n + g2) - torch.sqrt(n)) / alpha
            z_new = z + g - sigma * w
            n_new = n + g2
            shrunk = torch.sign(z_new) * torch.clamp(
                z_new.abs() - lambda1, min=0.0)
            w_new = -shrunk / ((beta + torch.sqrt(n_new)) / alpha + lambda2)
            return w_new - w, z_new, n_new

        updates, z, n = _unzip(
            grads, tree_map(per_leaf, grads, state.z, state.n, params), 3)
        return updates, FTRLState(z=z, n=n)

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# DCASGD — delayed-compensation async SGD (paramserver.h:252-287)
# ---------------------------------------------------------------------------

class DCASGDState(NamedTuple):
    shadow: dict  # the params at pull time


def dcasgd(learning_rate: float, lambda_dc: float = 2.0
           ) -> GradientTransformation:
    """w -= lr * (g + lambda * g^2 * (w - w_shadow)); shadow <- w_new: the
    compensation term approximates the gradient the *current* params would
    have produced (paramserver.h's DCASGD branch)."""

    def init_fn(params):
        return DCASGDState(shadow=tree_map(torch.clone, params))

    def update_fn(grads, state, params=None):
        _require_params("dcasgd", params)
        updates = tree_map(
            lambda g, w, s: -learning_rate * (g + lambda_dc * g * g * (w - s)),
            grads, params, state.shadow)
        shadow = tree_map(lambda w, u: w + u, params, updates)
        return updates, DCASGDState(shadow=shadow)

    return GradientTransformation(init_fn, update_fn)


class DCASGDAState(NamedTuple):
    shadow: dict  # the params at pull time
    accum: dict   # EMA of g^2 (the adaptive denominator)


def dcasgda(learning_rate: float, lambda_dc: float = 0.1,
            momentum: float = 0.95, eps: float = 1e-7
            ) -> GradientTransformation:
    """DCASGD-a, the PS's adaptive delayed-compensation variant
    (paramserver.h:269-287):

        accum <- m * accum + (1 - m) * g^2
        w -= lr * (g + lambda * g^2 * (w - shadow) / sqrt(accum + eps))
        shadow <- w_new
    """

    def init_fn(params):
        return DCASGDAState(shadow=tree_map(torch.clone, params),
                            accum=tree_map(torch.zeros_like, params))

    def update_fn(grads, state, params=None):
        _require_params("dcasgda", params)
        accum = tree_map(lambda a, g: momentum * a + (1.0 - momentum) * g * g,
                         state.accum, grads)
        updates = tree_map(
            lambda g, w, s, a: -learning_rate
            * (g + lambda_dc * g * g * (w - s) * torch.rsqrt(a + eps)),
            grads, params, state.shadow, accum)
        shadow = tree_map(lambda w, u: w + u, params, updates)
        return updates, DCASGDAState(shadow=shadow, accum=accum)

    return GradientTransformation(init_fn, update_fn)


# ---------------------------------------------------------------------------
# Composable extras
# ---------------------------------------------------------------------------

def clip_by_value(threshold: float) -> GradientTransformation:
    """Elementwise gradient clipping to [-t, t] (Matrix::clipping,
    matrix.h:152-162, fullyconnLayer.h:129-131)."""

    def init_fn(params):
        return EmptyState()

    def update_fn(grads, state, params=None):
        return tree_map(lambda g: g.clamp(-threshold, threshold),
                        grads), state

    return GradientTransformation(init_fn, update_fn)


def identity() -> GradientTransformation:
    """The no-op transform (``optax.identity``)."""

    def init_fn(params):
        return EmptyState()

    def update_fn(grads, state, params=None):
        return grads, state

    return GradientTransformation(init_fn, update_fn)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Transforms applied in turn (``optax.chain``): each one's updates are
    the next one's gradients; the state is the tuple of their states."""

    def init_fn(params):
        return tuple(t.init(params) for t in transforms)

    def update_fn(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init_fn, update_fn)


def add_decayed_regularization(lambda_l2: float = 0.0,
                               lambda_l1: float = 0.0
                               ) -> GradientTransformation:
    """Adds d/dw of L2Reg/L1Reg (gradientUpdater.h:30-42) to the
    gradient."""

    def init_fn(params):
        return EmptyState()

    def update_fn(grads, state, params=None):
        _require_params("regularization", params)
        return tree_map(
            lambda g, w: g + lambda_l2 * w + lambda_l1 * torch.sign(w),
            grads, params), state

    return GradientTransformation(init_fn, update_fn)


_REGISTRY = {
    "sgd": sgd,
    "adagrad": adagrad,
    "rmsprop": rmsprop,
    "adadelta": adadelta,
    "adam": adam,
    "ftrl": ftrl,
    "dcasgd": dcasgd,
    "dcasgda": dcasgda,
}


def get(name: str, **kw) -> GradientTransformation:
    try:
        return _REGISTRY[name](**kw)
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(_REGISTRY)}")
