"""Shared model and trainer plumbing, the port's counterpart of
``lightctr_tpu/models/_common.py``: carrying the JAX package's parameter
trees and optimizer state (as numpy) across, and copying trees."""

from __future__ import annotations

import numpy as np
import torch

from lightctr_tpu_torch.optim.updaters import AdagradState, AdamState, tree_map


def tree_copy(tree):
    """A copy of a (nested) dict of tensors on fresh storage.  The trainers
    update their params and optimizer state in place, so a tree the caller
    keeps (an init tree that seeds several trainers) is copied first."""
    return tree_map(lambda x: x.detach().clone(), tree)


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(np_params, device):
    """A (nested) dict or list of numpy arrays — e.g. the JAX package's
    params through ``np.asarray``: FM's ``{"w", "v"}``, the Wide&Deep
    family's and NFM's ``{"w", ..., "fc1": {"w", "b"}, ...}``, or the
    sequence model's ``{"embed", "pos", "blocks": [{...}, ...], "head"}``
    — as tensors on ``device``, the same tree."""
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
    ``sres``.  Accumulator trees may nest (a model's dense sub-layers).
    The JAX mesh state stacks one EF residual per rank (``[n, ...]``);
    rank ``rank`` takes its slice."""
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
    raise ValueError(f"not an Adagrad or Adam optimizer state: "
                     f"{type(np_state)}")
