"""Checkpoint / resume.

The port's counterpart of ``lightctr_tpu/ckpt/checkpoint.py``.  The
reference's persistence is thin: text-file model exports per algorithm
(fm_algo_abst.h:109-135, ...), an unwired mmap ``PersistentBuffer`` and a
"params backup to disk" TODO in the PS (paramserver.h:309).  This module
writes full trees of params + optimizer state, and the PS shards' row
snapshots.

API: ``save(dir, step, state)`` / ``restore(dir, step=None, like=None)``,
a ``Checkpointer`` with retention, and the crash-safe PS-shard row
snapshot pair ``save_arrays`` / ``load_latest_arrays`` — the migration
source when a shard dies without a farewell (docs/ELASTICITY.md).

The format is torch-native.  The JAX package writes through Orbax, which
has no torch counterpart; here ``step_N/`` holds ``leaves.pt`` (the tree's
leaves as CPU tensors, one ``torch.save`` of a list, read back with
``weights_only=True``) beside ``tree.json`` (the tree: dicts, lists,
tuples, NamedTuples by class, and where each leaf came from — a tensor on
its device, a numpy array or a Python number).  ``restore(like=)`` takes
the structure from ``like`` (the port's NamedTuple optimizer states
included) and puts each leaf on ``like``'s leaf's device and dtype.  The
``rows_N.npz`` snapshots stay plain npz with the JAX package's members, so
either package reads the other's.

Crash safety: every write lands in a same-directory tmp path (``.step_N.
tmp-<pid>``, ``.rows_N.tmp-<pid>.npz``), is fsynced, and is renamed into
place, so a writer killed mid-save leaves a ``*.tmp-*`` turd, never a
half-written ``step_N`` a reader could mistake for a checkpoint.  Readers
and the retention sweep skip torn or partial directories instead of
crashing.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

_LOG = logging.getLogger(__name__)

#: the two files of a step directory
TREE_FILE = "tree.json"
LEAVES_FILE = "leaves.pt"
FORMAT = "lightctr_tpu_torch.ckpt/1"


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """Durability for the RENAME itself: the directory entry must reach
    the disk or a crash can forget a fully-written checkpoint."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY dirs: rename stays atomic
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _commit_dir(tmp: str, final: str) -> None:
    """fsync every file in ``tmp``, then atomically rename over ``final``.
    A previous checkpoint at ``final``, complete or torn, is replaced
    (save(force) semantics)."""
    for root, _, files in os.walk(tmp):
        for f in files:
            _fsync_file(os.path.join(root, f))
        _fsync_dir(root)
    if os.path.isdir(final):
        shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    _fsync_dir(os.path.dirname(final) or ".")


# -- the tree description ------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _describe(tree, leaves: list):
    """The JSON node of ``tree``; its leaves appended to ``leaves`` as CPU
    tensors."""
    if isinstance(tree, dict):
        return {"dict": [[k, _describe(v, leaves)] for k, v in tree.items()]}
    if _is_namedtuple(tree):
        cls = type(tree)
        return {"namedtuple": f"{cls.__module__}:{cls.__qualname__}",
                "fields": [[f, _describe(getattr(tree, f), leaves)]
                           for f in tree._fields]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_describe(v, leaves) for v in tree]}
    if tree is None:
        return {"none": True}
    if isinstance(tree, torch.Tensor):
        leaves.append(tree.detach().cpu().contiguous())
        return {"leaf": len(leaves) - 1, "kind": "tensor",
                "device": str(tree.device)}
    if isinstance(tree, (np.ndarray, np.generic)):
        leaves.append(torch.from_numpy(np.array(tree, copy=True)))
        return {"leaf": len(leaves) - 1, "kind": "numpy"}
    if isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__}")


def _namedtuple_class(name: str):
    """The port's NamedTuple class ``module:qualname``; None for a class
    outside the port (it is rebuilt as a dict)."""
    module, qual = name.split(":", 1)
    if module.split(".")[0] != "lightctr_tpu_torch":
        return None
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _leaf_out(node, leaves, device):
    t = leaves[node["leaf"]]
    if node["kind"] == "numpy":
        return t.numpy()
    dev = device if device is not None else node["device"]
    return t.to(dev)


def _build(node, leaves, device):
    """The tree of ``node`` from its own description."""
    if "dict" in node:
        return {k: _build(v, leaves, device) for k, v in node["dict"]}
    if "namedtuple" in node:
        fields = {f: _build(v, leaves, device) for f, v in node["fields"]}
        cls = _namedtuple_class(node["namedtuple"])
        return cls(**fields) if cls is not None else fields
    if "list" in node:
        return [_build(v, leaves, device) for v in node["list"]]
    if "tuple" in node:
        return tuple(_build(v, leaves, device) for v in node["tuple"])
    if "none" in node:
        return None
    if "value" in node:
        return node["value"]
    return _leaf_out(node, leaves, device)


def _like(node, like, leaves, where="state"):
    """The tree of ``like``'s structure with the saved leaves of ``node``,
    each on the device and dtype (a tensor) or dtype (a numpy array) of
    ``like``'s leaf in its place."""
    if isinstance(like, dict):
        have = dict(node.get("dict", node.get("fields", [])))
        missing = [k for k in like if k not in have]
        if missing or len(have) != len(like):
            raise ValueError(f"restore: {where} holds keys {sorted(have)}, "
                             f"the template {sorted(like)}")
        return {k: _like(have[k], v, leaves, f"{where}/{k}")
                for k, v in like.items()}
    if _is_namedtuple(like):
        have = dict(node.get("fields", node.get("dict", [])))
        if set(have) != set(like._fields):
            raise ValueError(f"restore: {where} holds fields {sorted(have)}, "
                             f"the template {list(like._fields)}")
        return type(like)(**{f: _like(have[f], getattr(like, f), leaves,
                                      f"{where}/{f}") for f in like._fields})
    if isinstance(like, (list, tuple)):
        items = node.get("list", node.get("tuple"))
        if items is None or len(items) != len(like):
            raise ValueError(f"restore: {where} does not match the "
                             f"template's {len(like)} items")
        return type(like)(_like(n, v, leaves, f"{where}/{i}")
                          for i, (n, v) in enumerate(zip(items, like)))
    if like is None:
        return None
    if "leaf" not in node:
        if "value" not in node:
            raise ValueError(f"restore: {where} is not a leaf")
        return type(like)(node["value"]) if isinstance(
            like, (bool, int, float, str)) else node["value"]
    t = leaves[node["leaf"]]
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"restore: {where} has shape {tuple(t.shape)}, "
                             f"the template {tuple(like.shape)}")
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return t.numpy().astype(np.asarray(like).dtype, copy=False)
    if isinstance(like, (bool, int, float)):
        return type(like)(t.item())
    return t


# -- step checkpoints ----------------------------------------------------------


def save(directory: str, step: int, state: Any) -> str:
    """Write one checkpoint under ``directory/step_N``; returns the path.
    Crash-safe: stages into ``.step_N.tmp-<pid>``, fsyncs, and renames
    into place, so readers never observe a torn ``step_N``."""
    path = os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".step_{step}.tmp-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    leaves: list = []
    desc = _describe(state, leaves)
    torch.save(leaves, os.path.join(tmp, LEAVES_FILE))
    with open(os.path.join(tmp, TREE_FILE), "w") as f:
        json.dump({"format": FORMAT, "step": int(step), "tree": desc}, f)
    _commit_dir(tmp, path)
    return path


def _writer_is_dead(pid_str: str) -> bool:
    """True only when the staging dir's writer pid PROVABLY no longer
    exists — anything ambiguous (unparseable, alive, or not ours to
    signal) keeps the dir, because a live writer may still be committing."""
    try:
        pid = int(pid_str)
    except ValueError:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        return False  # e.g. EPERM: the pid exists under another user
    return False


def _step_dirs(directory: str):
    """(step, name) for every WELL-FORMED step dir — tmp or torn names
    (``step_5.orbax-checkpoint-tmp-...``, ``.step_5.tmp-123``) never parse
    as a step."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and d.split("_", 1)[1].isdigit():
            out.append((int(d.split("_", 1)[1]), d))
    return sorted(out)


def _is_complete(path: str) -> bool:
    """A step dir a reader may trust: the commit is a rename, so a dir
    under the final name with its payload is complete; an empty one (made,
    then its writer killed, under an older layout, or a partial copy) is
    torn."""
    if not os.path.isdir(path):
        return False
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    return bool(entries)


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETE step (torn or partial dirs are skipped)."""
    steps = [s for s, d in _step_dirs(directory)
             if _is_complete(os.path.join(directory, d))]
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None, like: Any = None,
            device=None) -> Any:
    """Load a checkpoint (the latest complete one if ``step`` is None).

    ``like`` is a template tree: the result takes its structure (its
    NamedTuple types), and each leaf its leaf's device and dtype.  Without
    it the saved structure is rebuilt (the port's NamedTuples by class),
    tensors on ``device`` or, if that is None, on the device they were
    saved from."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, TREE_FILE)) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} checkpoint")
    leaves = torch.load(os.path.join(path, LEAVES_FILE), map_location="cpu",
                        weights_only=True)
    if like is not None:
        return _like(meta["tree"], like, leaves)
    return _build(meta["tree"], leaves, device)


# -- PS-shard row snapshots (the elastic-rebalance migration source) ----------


def save_arrays(directory: str, step: int, keys: np.ndarray,
                rows: np.ndarray, accums: Optional[np.ndarray] = None) -> str:
    """Crash-safe (tmp + fsync + atomic rename) snapshot of a PS shard's
    (keys, rows), in the JAX package's npz members (``keys``, ``rows``,
    ``step``, optional ``accums``) so either package reads the other's.
    ``accums`` adds the shard's optimizer accumulators, so an elastic
    rebalance can migrate optimizer STATE, not just rows."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"rows_{int(step)}.npz")
    tmp = os.path.join(directory, f".rows_{int(step)}.tmp-{os.getpid()}.npz")
    keys = np.ascontiguousarray(keys, np.int64)
    rows = np.ascontiguousarray(rows, np.float32)
    if rows.shape[0] != keys.shape[0]:
        raise ValueError("keys/rows length mismatch")
    arrays = {"keys": keys, "rows": rows, "step": np.int64(step)}
    if accums is not None:
        accums = np.ascontiguousarray(accums, np.float32)
        if accums.shape != rows.shape:
            raise ValueError("accums/rows shape mismatch")
        arrays["accums"] = accums
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    _fsync_dir(directory)
    return final


def _load_latest(directory: str, with_accums: bool = True):
    """Newest intact ``rows_N.npz`` -> (step, keys, rows, accums-or-None);
    torn or unreadable snapshots are skipped with a warning.
    ``with_accums=False`` does not read the accumulator member (as large
    as ``rows``)."""
    if not os.path.isdir(directory):
        return None
    cands = []
    for fn in os.listdir(directory):
        if fn.startswith("rows_") and fn.endswith(".npz"):
            stem = fn[len("rows_"):-len(".npz")]
            if stem.isdigit():
                cands.append((int(stem), fn))
    for step, fn in sorted(cands, reverse=True):
        path = os.path.join(directory, fn)
        try:
            with np.load(path) as z:
                keys = np.asarray(z["keys"], np.int64)
                rows = np.asarray(z["rows"], np.float32)
                accums = (np.asarray(z["accums"], np.float32)
                          if with_accums and "accums" in z.files else None)
            if rows.shape[0] != keys.shape[0]:
                raise ValueError("keys/rows length mismatch")
            if accums is not None and accums.shape != rows.shape:
                raise ValueError("accums/rows shape mismatch")
            return step, keys, rows, accums
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            _LOG.warning("skipping torn shard snapshot %s: %s", path, e)
    return None


def load_latest_arrays(
    directory: str,
) -> Optional[Tuple[int, np.ndarray, np.ndarray]]:
    """Newest readable ``rows_N.npz`` -> (step, keys, rows); None when the
    directory holds none.  A torn or unreadable snapshot is SKIPPED with a
    warning: restore walks back to the newest intact one."""
    out = _load_latest(directory, with_accums=False)
    if out is None:
        return None
    step, keys, rows, _ = out
    return step, keys, rows


def load_latest_state(
    directory: str,
) -> Optional[Tuple[int, np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Like :func:`load_latest_arrays` but WITH the optimizer accumulators:
    (step, keys, rows, accums), ``accums`` None for snapshots written
    without them (the rebalance then migrates rows only)."""
    return _load_latest(directory)


def gc_array_snapshots(directory: str, keep: int = 3) -> None:
    """Drop all but the newest ``keep`` row snapshots and any tmp turds."""
    if not os.path.isdir(directory):
        return
    cands = []
    for fn in os.listdir(directory):
        if fn.startswith(".rows_") and ".tmp-" in fn:
            try:
                os.unlink(os.path.join(directory, fn))
            except OSError:
                pass
        elif fn.startswith("rows_") and fn.endswith(".npz"):
            stem = fn[len("rows_"):-len(".npz")]
            if stem.isdigit():
                cands.append((int(stem), fn))
    for _, fn in sorted(cands, reverse=True)[keep:]:
        try:
            os.unlink(os.path.join(directory, fn))
        except OSError:
            pass


class Checkpointer:
    """Periodic checkpointing with retention — the harness the
    reference's TODO (paramserver.h:309) wanted."""

    def __init__(self, directory: str, keep: int = 3, every: int = 1):
        self.directory = directory
        self.keep = keep
        self.every = every

    def maybe_save(self, step: int, state: Any) -> Optional[str]:
        if step % self.every != 0:
            return None
        path = save(self.directory, step, state)
        self._gc()
        return path

    def restore_latest(self, like: Any = None) -> Any:
        return restore(self.directory, like=like)

    def _gc(self):
        """Retention sweep over COMPLETE checkpoints only.  Torn or
        partial step directories neither count against ``keep`` nor crash
        the sweep, and are never deleted here (a live writer may still be
        committing one).  STAGING turds (``.step_N.tmp-<pid>``) whose
        writer pid is provably gone ARE reaped, or crash/restart cycles
        would pile them up."""
        try:
            steps = [s for s, d in _step_dirs(self.directory)
                     if _is_complete(os.path.join(self.directory, d))]
            entries = os.listdir(self.directory)
        except OSError:
            return
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
        for d in entries:
            if d.startswith(".step_") and ".tmp-" in d \
                    and _writer_is_dead(d.rsplit("-", 1)[-1]):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
