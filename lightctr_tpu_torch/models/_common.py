"""Shared trainer plumbing, the port's counterpart of
``lightctr_tpu/models/_common.py``."""

from __future__ import annotations

from lightctr_tpu_torch.optim.updaters import tree_map


def tree_copy(tree):
    """A copy of a (nested) dict of tensors on fresh storage.  The trainers
    update their params and optimizer state in place, so a tree the caller
    keeps (an init tree that seeds several trainers) is copied first."""
    return tree_map(lambda x: x.detach().clone(), tree)
