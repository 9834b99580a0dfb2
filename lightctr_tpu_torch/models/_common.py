"""Shared model and trainer plumbing, the port's counterpart of
``lightctr_tpu/models/_common.py``: carrying the JAX package's parameter
trees and optimizer state (as numpy) across, copying trees, the DL
layers' default optimizer and the batch-size check."""

from __future__ import annotations

import numpy as np
import torch

from lightctr_tpu_torch.optim import updaters
from lightctr_tpu_torch.optim.updaters import AdagradState, AdamState, tree_map

#: the JAX package's NamedTuples of parameters -> the port module that
#: defines the NamedTuple of the same name and fields
_PARAM_TUPLES = {"GMMParams": "gmm", "PLSAParams": "plsa",
                 "Word2VecParams": "embedding", "Tree": "gbm"}


def tree_copy(tree):
    """A copy of a (nested) dict of tensors on fresh storage.  The trainers
    update their params and optimizer state in place, so a tree the caller
    keeps (an init tree that seeds several trainers) is copied first."""
    return tree_map(lambda x: x.detach().clone(), tree)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _port_tuple(name: str):
    import importlib

    mod = importlib.import_module(
        f"lightctr_tpu_torch.models.{_PARAM_TUPLES[name]}")
    return getattr(mod, name)


def params_from_numpy(np_params, device):
    """A (nested) dict or list of numpy arrays — e.g. the JAX package's
    params through ``np.asarray``: FM's ``{"w", "v"}``, the Wide&Deep
    family's and NFM's ``{"w", ..., "fc1": {"w", "b"}, ...}``, the sequence
    model's ``{"embed", "pos", "blocks": [{...}, ...], "head"}``, the DL
    zoo's conv/LSTM/attention dicts, or one of the NamedTuples
    ``GMMParams``, ``PLSAParams``, ``Word2VecParams`` and GBM's ``Tree``
    (as the port's NamedTuple of that name) — as tensors on ``device``,
    the same tree."""
    if _is_namedtuple(np_params):
        cls = _port_tuple(type(np_params).__name__)
        return cls(*(params_from_numpy(v, device) for v in np_params))
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, device)
                for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return type(np_params)(params_from_numpy(v, device)
                               for v in np_params)
    return _tensor(np_params, device)


def opt_state_from_numpy(np_state, device, rank: int = 0):
    """The JAX trainers' optimizer state (as numpy) -> the port's: an
    ``AdagradState`` (anything with an ``accum`` tree, ``CTRTrainer``'s
    state), an ``AdamState`` (``count``, ``mu``, ``nu``), the compressed ring's ``CompressedRingState`` (``inner`` and
    ``residual``), or the sparse trainer's ``{"dense": AdagradState,
    "accum": {table: [rows, ...]}}`` with, on a mesh, ``residual`` and
    ``sres``; a chain's tuple of states (``default_dl_optimizer``'s
    ``(EmptyState(), AdagradState)``), and the other optimizers' states of
    the same name and fields (``FTRLState``, ``RMSpropState``, ...).
    Accumulator trees may nest (a model's dense sub-layers).
    The JAX mesh state stacks one EF residual per rank (``[n, ...]``);
    rank ``rank`` takes its slice."""
    if isinstance(np_state, tuple) and not _is_namedtuple(np_state):
        return tuple(opt_state_from_numpy(s, device, rank)
                     for s in np_state)
    cls = getattr(updaters, type(np_state).__name__, None)
    if _is_namedtuple(np_state) and cls is not AdamState and \
            getattr(cls, "_fields", None) == np_state._fields:
        return cls(*(params_from_numpy(v, device) for v in np_state))
    if hasattr(np_state, "inner") and hasattr(np_state, "residual"):
        from lightctr_tpu_torch.models.ctr_trainer import CompressedRingState

        return CompressedRingState(
            inner=opt_state_from_numpy(np_state.inner, device),
            residual=_tensor(np_state.residual[rank], device))
    if {"count", "mu", "nu"} <= set(getattr(np_state, "_fields", ())):
        return AdamState(
            count=_tensor(np_state.count, device).to(torch.int32),
            mu=params_from_numpy(np_state.mu, device),
            nu=params_from_numpy(np_state.nu, device))
    if hasattr(np_state, "accum"):
        return AdagradState(accum=params_from_numpy(np_state.accum, device))
    if isinstance(np_state, dict) and {"dense", "accum"} <= set(np_state) \
            <= {"dense", "accum", "residual", "sres"}:
        out = {"dense": opt_state_from_numpy(np_state["dense"], device),
               "accum": params_from_numpy(np_state["accum"], device)}
        if "residual" in np_state:
            out["residual"] = _tensor(np_state["residual"][rank], device)
        if "sres" in np_state:
            out["sres"] = {k: _tensor(v[rank], device)
                           for k, v in np_state["sres"].items()}
        return out
    raise ValueError(f"not an Adagrad, Adam or other optimizer state of "
                     f"the port: {type(np_state)}")


def default_dl_optimizer(cfg) -> updaters.GradientTransformation:
    """The reference DL layers' updater: grad clip at ``cfg.grad_clip``
    (15) then Adagrad (fullyconnLayer.h:129-131, lstm_unit.h)."""
    return updaters.chain(
        updaters.clip_by_value(cfg.grad_clip) if cfg.grad_clip
        else updaters.identity(),
        updaters.adagrad(cfg.learning_rate))


def check_batch_size(n_rows: int, batch_size: int) -> None:
    if batch_size > n_rows:
        raise ValueError(
            f"batch_size={batch_size} exceeds dataset size {n_rows} "
            "(drop_remainder would yield zero batches)")
