"""Serving-side model: params in, batched scores out, on one device.

The port's counterpart of ``lightctr_tpu/serve/model.py``.  Scoring is one
eager call over a micro-batch, with the per-fid table leaves optionally
**PS-row-backed** — assembled per batch from rows the
:class:`~lightctr_tpu_torch.serve.server.PredictionServer` pulls through
its :class:`~lightctr_tpu_torch.serve.cache.HotEmbeddingCache`.

PS-backed scoring mirrors the sparse trainer's O(touched) recipe in
reverse: dedup the batch's ids, fetch ONLY the touched rows, rewrite the
id fields to positions, and let the unchanged model compute on the
gathered rows.  Shapes are padded (batch to a power of two, touched rows to
a power of two) exactly as in the JAX package, so both score the same
padded arrays.

The four kinds of the JAX package are served (``fm``, ``widedeep``,
``deepfm``, ``dcn``), and :func:`load_model` builds a model from a
compressed artifact of either package (``models/export.py``), decoded on
the model's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lightctr_tpu_torch.core.device import resolve_device
from lightctr_tpu_torch.obs import device as obs_device
from lightctr_tpu_torch.obs import resources as obs_resources
from lightctr_tpu_torch.ops.activations import sigmoid
from lightctr_tpu_torch.ops.sparse_kernels import next_pow2 as _next_pow2


def _kind_fm():
    from lightctr_tpu_torch.models import fm
    return fm.logits


def _kind_widedeep():
    from lightctr_tpu_torch.models import widedeep
    return widedeep.logits


def _kind_deepfm():
    from lightctr_tpu_torch.models import deepfm
    return deepfm.logits


def _kind_dcn():
    from lightctr_tpu_torch.models import deepfm
    return deepfm.dcn_logits


#: model kind -> zero-arg resolver of its ``logits(params, batch)`` fn
MODEL_KINDS = {
    "fm": _kind_fm,
    "widedeep": _kind_widedeep,
    "deepfm": _kind_deepfm,
    "dcn": _kind_dcn,
}

#: model kind -> the batch fields that index the per-fid table leaves
#: (the id streams a PS-backed deployment dedups and rewrites)
_ID_FIELDS = {
    "fm": ("fids",),
    "widedeep": ("fids", "rep_fids"),
    "deepfm": ("fids", "rep_fids"),
    "dcn": ("rep_fids",),
}

#: kinds whose batch layout carries the field-representative pair
_REP_KINDS = ("widedeep", "deepfm", "dcn")


def fm_ps_row_leaves(factor_dim: int, w_leaf: str = "w",
                     table_leaf: str = "v") -> Dict[str, Tuple[int, int, bool]]:
    """The fused ``[w | v]`` PS row layout the training soaks use
    (tools/criteo_ps_soak ROW_DIM = 1 + dim): leaf -> (lo, hi, squeeze)
    column slices of a pulled ``[K, 1 + factor_dim]`` row block.  Works
    for FM (``w``/``v``) and, with ``table_leaf="embed"``, for the
    Wide&Deep/DeepFM family; DCN, which has no wide table, reads
    ``{"embed": (1, 1 + factor_dim, False)}`` of the same rows
    (``row_dim=1 + factor_dim``)."""
    return {w_leaf: (0, 1, True),
            table_leaf: (1, 1 + int(factor_dim), False)}


def fused_fm_rows(params: Dict, w_leaf: str = "w",
                  table_leaf: str = "v") -> Tuple[np.ndarray, np.ndarray]:
    """(keys, rows) preloading a PS with the fused layout above: key = fid,
    row = ``[w[fid], table[fid, :]]``."""
    w = np.asarray(params[w_leaf], np.float32)
    t = np.asarray(params[table_leaf], np.float32)
    keys = np.arange(t.shape[0], dtype=np.int64)
    return keys, np.concatenate([w[:, None], t], axis=1)


def _to_device(v, device: torch.device):
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


class ServingModel:
    """One loaded model: local leaves on ``device`` + the score paths.

    ``row_leaves``: {leaf: (lo, hi, squeeze)} column slices of PS rows —
    when set, those leaves are NOT read from ``params`` at score time but
    assembled from the ``rows`` block :meth:`score_rows` receives (and
    ``row_dim`` names the PS row width).  Empty = fully local model.
    ``device``: where the leaves live and scoring runs (``"cuda"`` by
    default; raises on a host without CUDA unless ``"cpu"`` is passed).
    """

    def __init__(
        self,
        kind: str,
        params: Dict,
        row_leaves: Optional[Dict[str, Tuple[int, int, bool]]] = None,
        row_dim: Optional[int] = None,
        id_fields: Optional[Tuple[str, ...]] = None,
        device="cuda",
    ):
        if kind not in MODEL_KINDS:
            raise ValueError(
                f"unknown model kind {kind!r} (have {sorted(MODEL_KINDS)})"
            )
        self.kind = kind
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.logits_fn = MODEL_KINDS[kind]()
        self.row_leaves = dict(row_leaves or {})
        if self.row_leaves:
            need = max(hi for _, hi, _ in self.row_leaves.values())
            if row_dim is None:
                row_dim = need
            elif row_dim < need:
                raise ValueError(
                    f"row_dim {row_dim} cannot hold slices up to {need}"
                )
        self.row_dim = row_dim
        self.id_fields = tuple(id_fields or _ID_FIELDS[kind])
        # hot-swap generation: bumped by every swap_params flip
        self.version = 0
        # the pow2-padded scorer ladders: registered with the process
        # compile tracker (their distinct input signatures), so /resourcez
        # shows each ladder's size and a shape leak trips the
        # recompile-storm detector
        self._jit_local = obs_resources.track_jit(
            f"serve_score_local_{kind}", self._score_local)
        self._jit_rows = obs_resources.track_jit(
            f"serve_score_rows_{kind}", self._score_rows)

    def _score_local(self, params: Dict, batch: Dict) -> torch.Tensor:
        return sigmoid(self.logits_fn(params, batch))

    def _score_rows(self, params: Dict, rows: torch.Tensor,
                    batch: Dict) -> torch.Tensor:
        full = dict(params)
        for leaf, (lo, hi, squeeze) in self.row_leaves.items():
            sub = rows[:, lo:hi]
            full[leaf] = sub[:, 0] if squeeze else sub
        return sigmoid(self.logits_fn(full, batch))

    # -- dense hot-swap ------------------------------------------------------

    def swap_params(self, params: Dict) -> int:
        """Atomically flip the LOCAL (dense) leaves to ``params``.  The
        scorer reads ``self.params`` once per micro-batch, so the single
        reference assignment lands BETWEEN batches; PS-row-backed leaves
        are untouched.  The leaf set must match the current one; returns
        the new model version."""
        prepared = _to_device(params, self.device)
        if set(prepared) != set(self.params):
            raise ValueError(
                f"swap changes the leaf set {sorted(self.params)} -> "
                f"{sorted(prepared)} (structural change; redeploy instead)"
            )
        self.params = prepared
        self.version += 1
        return self.version

    # -- shape plumbing ------------------------------------------------------

    def _pad_batch(self, arrays: Dict, b_pad: int) -> Dict:
        out = {}
        for k, v in arrays.items():
            v = np.asarray(v)
            b = v.shape[0]
            if b_pad != b:
                pad = np.zeros((b_pad - b,) + v.shape[1:], v.dtype)
                v = np.concatenate([v, pad], axis=0)
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
        return out

    # -- request validation --------------------------------------------------

    def required_fields(self) -> Tuple[str, ...]:
        base = ("fids", "vals")
        if self.kind in _REP_KINDS:
            return base + ("rep_fids", "rep_mask")
        return base

    def canonicalize_request(self, arrays: Dict) -> Dict:
        """Validate one decoded predict frame against THIS model's layout
        and strip it to the canonical field set — done at admission so a
        malformed-but-decodable frame is rejected alone instead of
        poisoning the whole micro-batch it would be coalesced into."""
        missing = [f for f in self.required_fields() if f not in arrays]
        if missing:
            raise ValueError(
                f"predict frame for a {self.kind!r} model is missing "
                f"{missing} (send the rep_fids/rep_mask pair for the "
                "field-representative family, omit it for fm)"
            )
        out = {f: arrays[f] for f in self.required_fields()}
        b = int(np.asarray(out["fids"]).shape[0])
        if b < 1:
            raise ValueError("empty predict frame (B == 0)")
        out["mask"] = (np.asarray(arrays["mask"], np.float32)
                       if "mask" in arrays
                       else np.ones_like(np.asarray(out["vals"],
                                                    np.float32)))
        return out

    # -- score paths ---------------------------------------------------------

    @torch.inference_mode()
    def score(self, arrays: Dict) -> np.ndarray:
        """Fully-local scoring: ``arrays`` is the model's batch layout
        (``labels`` optional/ignored); returns [B] fp32 probabilities.
        The batch is padded to a power of two, as in the JAX package."""
        arrays = self._with_mask(arrays)
        b = int(np.asarray(arrays["fids"]).shape[0]) if "fids" in arrays \
            else int(np.asarray(arrays["rep_fids"]).shape[0])
        batch = self._pad_batch(arrays, _next_pow2(b))
        # device-plane program record (the plain call unless
        # LIGHTCTR_DEVICE arms the process catalog)
        return obs_device.call(f"serve_score_local_{self.kind}",
                               self._jit_local, (self.params, batch)
                               )[:b].cpu().numpy()

    @staticmethod
    def _with_mask(arrays: Dict) -> Dict:
        """Drop labels, default ``mask`` to ones — the wire sends vals
        pre-masked (dist/wire.py predict frames), so a missing mask means
        'everything you got is live'."""
        arrays = {k: v for k, v in arrays.items() if k != "labels"}
        if "mask" not in arrays and "vals" in arrays:
            arrays["mask"] = np.ones_like(
                np.asarray(arrays["vals"], np.float32))
        return arrays

    def touched_uids(self, arrays: Dict) -> np.ndarray:
        """Sorted unique ids this batch touches across the model's id
        fields — the stream the cache ledger and the PS pull consume."""
        streams = [np.asarray(arrays[f]).reshape(-1)
                   for f in self.id_fields if f in arrays]
        if not streams:
            raise ValueError(
                f"batch carries none of the id fields {self.id_fields}"
            )
        return np.unique(np.concatenate(streams).astype(np.int64))

    @torch.inference_mode()
    def score_rows(self, arrays: Dict, uids: np.ndarray,
                   rows) -> np.ndarray:
        """PS-backed scoring: ``uids`` is the SORTED unique id cover of
        the batch's id fields (``touched_uids``), ``rows`` the matching
        ``[K, row_dim]`` fp32 PS rows (numpy, or a tensor — the cache's
        device gather stays on the device).  Id fields are rewritten to
        row positions host-side, rows are padded to a power of two (zero
        rows — positions never point past K)."""
        if not self.row_leaves:
            raise ValueError("score_rows needs row_leaves (PS-backed mode)")
        uids = np.asarray(uids, np.int64)
        if not isinstance(rows, torch.Tensor):
            rows = torch.from_numpy(np.ascontiguousarray(rows, np.float32))
        rows = rows.to(self.device, torch.float32).reshape(
            len(uids), self.row_dim)
        arrays = self._with_mask(arrays)
        b = int(np.asarray(arrays[self.id_fields[0]]).shape[0])
        batch = dict(arrays)
        for f in self.id_fields:
            if f not in batch:
                continue
            ids = np.asarray(batch[f], np.int64)
            pos = np.searchsorted(uids, ids.reshape(-1))
            if pos.max(initial=0) >= len(uids) or \
                    np.any(uids[np.minimum(pos, len(uids) - 1)]
                           != ids.reshape(-1)):
                raise ValueError(
                    f"id field {f!r} carries ids outside the uid cover"
                )
            batch[f] = pos.reshape(ids.shape).astype(np.int32)
        k_pad = _next_pow2(len(uids))
        if k_pad != len(uids):
            rows = torch.cat([rows, rows.new_zeros(
                (k_pad - len(uids), self.row_dim))], dim=0)
        dev_batch = self._pad_batch(batch, _next_pow2(b))
        return obs_device.call(f"serve_score_rows_{self.kind}",
                               self._jit_rows, (self.params, rows, dev_batch)
                               )[:b].cpu().numpy()


def load_model(
    path: str,
    row_leaves: Optional[Dict[str, Tuple[int, int, bool]]] = None,
    row_dim: Optional[int] = None,
    id_fields: Optional[Tuple[str, ...]] = None,
    device="cuda",
) -> ServingModel:
    """Compressed artifact (``models/export.save_compressed_npz``, either
    package's) -> :class:`ServingModel` on ``device``, every leaf decoded
    there.  ``row_leaves`` switches the named table leaves to
    PS-row-backed serving (the decoded local copies are kept, for parity
    checks and preloads)."""
    from lightctr_tpu_torch.models.export import load_compressed_npz

    params, meta = load_compressed_npz(path, device=device)
    return ServingModel(
        meta["model"], params, row_leaves=row_leaves, row_dim=row_dim,
        id_fields=id_fields, device=device,
    )
