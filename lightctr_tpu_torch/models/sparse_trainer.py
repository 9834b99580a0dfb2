"""O(touched-rows) training for huge-vocab CTR models, on one device.

The port's counterpart of the single-device step of
``lightctr_tpu/models/sparse_trainer.py``.  The reference PS updates only
the keys a batch pushed (``paramserver.h:287-295`` walks the pushed map);
autograd over a [vocab, dim] table would materialize a dense gradient and
a dense optimizer update would walk every row — O(vocab) per step,
ruinous at Criteo vocabularies (2^20+ rows for a few hundred thousand
touched).

:class:`SparseTableCTRTrainer` restores O(touched) without changing the
model code, exploiting that the models only use their tables through
``index_select(table, batch[field])``:

  1. per step, dedup each id stream: ``uids, inv = unique(ids)`` (the
     ``dedup_ids`` kernel on the card; static shape ``size=ids.numel()``,
     padded with id 0);
  2. gather ``rows = table[uids]`` — O(touched);
  3. rewrite the batch's id fields to POSITIONS (``inv``) and substitute
     the rows for the table leaf, so the unchanged model computes on the
     gathered rows;
  4. differentiate w.r.t. the rows ([n_unique, dim], fresh autograd leaves:
     autograd never sees the table) and the dense leaves;
  5. dense leaves update through the optimizer transform; table rows
     through sparse Adagrad (accum rows += g^2; w rows -= lr*g*rsqrt(accum
     + eps)) applied **in place** at ``uids`` by the ``merge_apply`` kernel
     — what buffer donation gives the JAX trainer.

The trajectory is the dense Adagrad trainer's: untouched rows have zero
gradient there, so neither their weights nor their accumulators move
(parity-tested).  Padded dedup slots repeat id 0 and are never referenced
by ``inv``, so they carry zero gradient and the apply skips them.

Not yet ported: the multi-device paths (``mesh``, ``param_shardings``,
``compress_bits``, ``hier_exchange``) and the quality plane
(``quality_bins``); giving one raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lightctr_tpu_torch.models.ctr_trainer import (
    CTRTrainer,
    _health_pack,
    _host,
    global_norm,
    grads_of,
    leaves_requiring_grad,
    not_yet_ported,
)
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.ops import sparse_kernels
from lightctr_tpu_torch.utils.profiling import annotate


class SparseTableCTRTrainer(CTRTrainer):
    """CTRTrainer whose listed table leaves update O(touched) per step.

    Parameters (beyond CTRTrainer's)
    --------------------------------
    sparse_tables: {param_key: [batch_id_field, ...]} — top-level param
        leaves that are [rows, ...] tables indexed ONLY via
        ``index_select`` with the listed batch fields (e.g. FM:
        ``{"w": ["fids"], "v": ["fids"]}``).
    eps: the sparse Adagrad's epsilon (inside the sqrt).
    """

    def __init__(
        self,
        params,
        logits_fn,
        cfg,
        sparse_tables: Dict[str, Sequence[str]],
        l2_fn=None,
        fused_fn=None,
        mesh=None,
        param_shardings=None,
        eps: float = 1e-7,
        compress_bits: Optional[int] = None,
        hier_exchange=None,
        quality_bins: Optional[int] = None,
        device="cuda",
    ):
        if not sparse_tables:
            raise ValueError("sparse_tables must name at least one table leaf")
        for k in sparse_tables:
            if k not in params:
                raise ValueError(f"sparse_tables key {k!r} not in params")
        self._spec = {k: tuple(v) for k, v in sparse_tables.items()}
        # A batch field shared by two tables is only coherent when both
        # tables list the IDENTICAL field tuple (then their unique/inverse
        # mappings coincide and the position rewrite is the same).  Any
        # other overlap would silently rewrite the field with the LAST
        # table's inverse and train the wrong rows of the others.
        owner: Dict[str, str] = {}
        for k, fields in self._spec.items():
            for f in fields:
                if f in owner and self._spec[owner[f]] != self._spec[k]:
                    raise ValueError(
                        f"batch field {f!r} is listed under tables "
                        f"{owner[f]!r} {self._spec[owner[f]]} and {k!r} "
                        f"{self._spec[k]} with different field tuples — "
                        "the position rewrite would be ambiguous"
                    )
                owner[f] = k
        not_yet_ported(type(self).__name__, hier_exchange=hier_exchange)
        self._eps = eps
        super().__init__(
            params, logits_fn, cfg, l2_fn=l2_fn, fused_fn=fused_fn, mesh=mesh,
            param_shardings=param_shardings, compress_bits=compress_bits,
            quality_bins=quality_bins, device=device,
        )
        # table trainers also watch per-table touched-uid skew
        if self.health is not None:
            health_mod.ensure_trainer_detectors(self.health, tables=True)

    # -- state -------------------------------------------------------------

    def _init_opt_state(self, params):
        """Dense leaves get the optimizer's state; table leaves get per-row
        Adagrad accumulators only (never a full-size dense state)."""
        dense = {k: v for k, v in params.items() if k not in self._spec}
        return {
            "dense": self.tx.init(dense),
            "accum": {k: torch.zeros_like(params[k]) for k in self._spec},
        }

    # -- step --------------------------------------------------------------

    @staticmethod
    def _field_groups(spec) -> Dict[tuple, list]:
        """{field_tuple: [table, ...]} in spec order — tables whose field
        lists concatenate to the SAME id stream share one dedup."""
        groups: Dict[tuple, list] = {}
        for k, fields in spec.items():
            groups.setdefault(tuple(fields), []).append(k)
        return groups

    @staticmethod
    def _dedup_and_gather(spec, params, batch):
        """Steps 1-3 of the module recipe: per-stream batch-id dedup,
        position rewrite, and the O(touched) row gather.  Tables listing
        the IDENTICAL field tuple run the dedup once and share the
        resulting ``(uids, inv)``, so dedup work is paid per distinct id
        stream, not per table."""
        tables = {k: params[k] for k in spec}
        dense = {k: v for k, v in params.items() if k not in spec}
        batch2 = dict(batch)
        uids = {}
        groups = SparseTableCTRTrainer._field_groups(spec)
        with annotate("sparse_tables/dedup_gather", tables=len(spec),
                      id_streams=len(groups)):
            for fields, keys in groups.items():
                ids = torch.cat(
                    [batch[f].reshape(-1) for f in fields]
                ).to(torch.int32)
                u, inv, _ = sparse_kernels.dedup_ids(ids)
                for k in keys:
                    uids[k] = u
                ofs = 0
                for f in fields:
                    m = batch[f].numel()
                    batch2[f] = inv[ofs:ofs + m].reshape(batch[f].shape)
                    ofs += m
            rows = {k: tables[k].index_select(0, uids[k]) for k in spec}
        return tables, dense, batch2, uids, rows

    def _make_step(self):
        loss_fn = self._make_loss_fn()
        tx = self.tx
        spec = self._spec
        lr, eps = self.cfg.learning_rate, self._eps
        dedup_and_gather = self._dedup_and_gather

        def step(params, opt_state, batch):
            tables, dense, batch2, uids, rows = dedup_and_gather(
                spec, params, batch)
            rows = leaves_requiring_grad(rows)
            dense_leaves = leaves_requiring_grad(dense)
            loss = loss_fn({**dense_leaves, **rows}, batch2)
            loss.backward()
            g_rows, g_dense = grads_of(rows), grads_of(dense_leaves)
            with torch.no_grad():
                # grad global norm over touched rows + dense leaves: the
                # health scalar (one reduction; fetched only when read)
                gnorm = global_norm({"rows": g_rows, "dense": g_dense})
                updates, new_dense_state = tx.update(
                    g_dense, opt_state["dense"], dense)
                dense = {k: p + updates[k].to(p.dtype)
                         for k, p in dense.items()}
                with annotate("sparse_tables/apply"):
                    for k in spec:
                        # in place on the table and its accumulator; the
                        # uids are unique apart from the id-0 pads, which
                        # carry zero gradient
                        sparse_kernels.merge_apply(
                            tables[k], opt_state["accum"][k], uids[k],
                            g_rows[k], None, lr=lr, eps=eps)
            params = {**dense, **tables}
            health = _health_pack(loss.detach(), gnorm)
            return (params, {"dense": new_dense_state,
                             "accum": opt_state["accum"]},
                    loss.detach(), health)

        return step

    # -- telemetry ------------------------------------------------------

    def _health_signals(self, batch) -> Dict:
        """Per-table touched-uid counts for the skew detector, counted on
        the host from the caller's batch (no device round trip), once per
        id stream: tables sharing a field tuple share the count.  Skipped
        entirely unless a table_skew detector is installed."""
        hm = self.health
        if hm is None or not hm.wants("table_touch"):
            return {}
        touch = {}
        for fields, keys in self._field_groups(self._spec).items():
            ids = np.concatenate([_host(batch[f]).reshape(-1)
                                  for f in fields])
            unique = int(np.unique(ids).size)
            for k in keys:
                touch[k] = {"unique": unique, "ids": int(ids.size),
                            "vocab": int(self.params[k].shape[0])}
        return {"table_touch": touch}
