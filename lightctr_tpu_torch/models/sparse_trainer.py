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

Replicated data parallelism (``mesh`` given, no ``param_shardings``) runs
the JAX trainer's explicit HYBRID exchange, Parallax's split by variable
type (arXiv:1808.02621) with SparCML's sparse allreduce
(arXiv:1802.08021), one rank per process:

  - each rank dedups its LOCAL rows' ids and differentiates w.r.t. its
    gathered rows (O(touched) as above); tables listing the identical field
    tuple share one id stream;
  - per table a static pick from shapes (``pick_exchange_algo``) sends the
    gradient over the sparse allgather exchange — the ids gathered and
    deduped once per stream (``dedup_ids`` on the gathered stream), the
    rows gathered (exact, quantile-coded with the ``quantize_pack``
    kernel, or, for a FIXED range with error feedback, coded by the
    ``quantize_pack_ef_update`` kernel with its per-table carry) and
    merged with the mean inside the fused apply (``merge_apply``'s merge
    mode: the ``merge_rows`` kernel, then the apply) — or, past the
    density switch, as a dense [vocab, ...] buffer over the mean or the
    coded ring; every rank applies the identical update, so replicas
    cannot diverge.  ``self.exchange_policy`` records the pick;
  - dense leaves ride the coded ring with ``compress_bits`` (EF-SGD
    residual and all, CTRTrainer's compressed path), the plain mean
    otherwise.

Not yet ported: the reduce-scatter exchange (a ``"sparse_rs"`` pick
raises; FM at Criteo width never picks it at 2 or 4 ranks),
``param_shardings``, ``hier_exchange`` and the quality plane
(``quality_bins``); giving one raises ``ValueError``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.dist import collectives
from lightctr_tpu_torch.models.ctr_trainer import (
    CTRTrainer,
    _health_pack,
    _host,
    global_norm,
    grads_of,
    leaves_requiring_grad,
    not_yet_ported,
    sum_squares,
)
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.ops import sparse_kernels
from lightctr_tpu_torch.optim.updaters import tree_map
from lightctr_tpu_torch.utils.profiling import annotate

#: every ``trainer_*`` exchange series this module emits (the JAX module's
#: EXCHANGE_SERIES, as far as the ported branches emit them)
EXCHANGE_SERIES = (
    "trainer_exchange_bytes_total",      # {table, policy} bytes/step
    "trainer_exchange_algo_total",       # {table, algo} steps per decision
    "trainer_sparse_exchange_bytes_total",
    "trainer_dense_ring_bytes_total",
    "trainer_rs_overflow_total",
)


class SparseTableCTRTrainer(CTRTrainer):
    """CTRTrainer whose listed table leaves update O(touched) per step.

    Parameters (beyond CTRTrainer's)
    --------------------------------
    sparse_tables: {param_key: [batch_id_field, ...]} — top-level param
        leaves that are [rows, ...] tables indexed ONLY via
        ``index_select`` with the listed batch fields (e.g. FM:
        ``{"w": ["fids"], "v": ["fids"]}``).
    eps: the sparse Adagrad's epsilon (inside the sqrt).
    compress_bits / compress_range / compress_mode / error_feedback: as in
        CTRTrainer, applied to the hybrid exchange (mesh given): dense
        leaves ride the coded ring, table leaves' sparse value payloads
        are coded with the same table — with a fixed float range and error
        feedback, through a per-table EF carry.
    dense_switch_margin: scale on the SparCML density switch — a table
        takes the sparse exchange only while its sparse bytes stay under
        ``margin * dense_ring_bytes``.
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
        compress_range=1.0,
        compress_mode: Optional[str] = None,
        error_feedback: Optional[bool] = None,
        dense_switch_margin: float = 1.0,
        hier_exchange=None,
        quality_bins: Optional[int] = None,
        device=None,
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
        self._dense_margin = dense_switch_margin
        # mesh WITHOUT explicit shardings = replicated data parallelism:
        # the explicit hybrid exchange
        self._hybrid_dp = mesh is not None and param_shardings is None
        # {table: "sparse" | "dense"} — the pick each table leaf got, and
        # {table: bytes each rank transmits per step under it}, written by
        # the step with the accounting helpers of dist.collectives
        self.exchange_policy: Dict[str, str] = {}
        self.exchange_bytes_per_step: Dict[str, int] = {}
        self._exchange_logged = False
        super().__init__(
            params, logits_fn, cfg, l2_fn=l2_fn, fused_fn=fused_fn, mesh=mesh,
            param_shardings=param_shardings, compress_bits=compress_bits,
            compress_range=compress_range, compress_mode=compress_mode,
            error_feedback=error_feedback, quality_bins=quality_bins,
            device=device,
        )
        # table trainers also watch per-table touched-uid skew
        if self.health is not None:
            health_mod.ensure_trainer_detectors(self.health, tables=True)

    # -- state -------------------------------------------------------------

    def _ring_tree(self, params):
        """Only the dense leaves ride the compressed ring — the table
        leaves have their own sparse exchange (Parallax's split)."""
        return {k: v for k, v in params.items() if k not in self._spec}

    def _use_sparse_ef(self) -> bool:
        """Fixed-range clipped sparse payloads carry a per-table EF
        residual: hybrid exchange + compress_bits + error feedback + a
        FIXED float compress_range (dynamic never clips)."""
        return (self._hybrid_dp and self.compress_bits is not None
                and self.error_feedback
                and isinstance(self.compress_range, (int, float)))

    def _init_opt_state(self, params):
        """Dense leaves get the optimizer's state; table leaves get per-row
        Adagrad accumulators only (never a full-size dense state).  With
        ``compress_bits`` this rank's dense-ring EF residual rides along;
        with a fixed float range each table also carries this rank's
        [vocab, ...] sparse EF residual (the JAX state's [n, vocab, ...]
        stack holds one per rank): n x table size in all, a deliberate
        bandwidth/memory trade."""
        dense = {k: v for k, v in params.items() if k not in self._spec}
        state = {
            "dense": self.tx.init(dense),
            "accum": {k: torch.zeros_like(params[k]) for k in self._spec},
        }
        if self.compress_bits is not None:
            state["residual"] = torch.zeros(
                self._ring_pad if self.error_feedback else 1,
                dtype=torch.float32, device=self.device)
        if self._use_sparse_ef():
            state["sres"] = {
                k: collectives.sparse_ef_residual_init(self.mesh,
                                                       params[k].shape)
                for k in self._spec}
        return state

    def _build_step(self):
        """Replicated data parallelism takes the explicit hybrid exchange;
        one device keeps the O(touched) step."""
        if self._hybrid_dp:
            return self._make_hybrid_dp_step()
        return self._make_step()

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

    def _make_hybrid_dp_step(self):
        """Replicated data-parallel step with the hybrid explicit exchange
        (module docstring): per-rank O(touched) grads, table leaves over
        the picked exchange (the sparse allgather or, past the density
        switch, the dense mean/ring), dense leaves over the coded ring or
        the plain mean.  Tables sharing a field tuple share the exchanged
        id stream: only the first table of a group pays the id bytes."""
        loss_fn = self._make_loss_fn()
        tx = self.tx
        spec = self._spec
        lr, eps = self.cfg.learning_rate, self._eps
        dedup_and_gather = self._dedup_and_gather
        groups = self._field_groups(spec)
        mesh = self.mesh
        n = mesh.size
        bits = self.compress_bits
        crange, cmode = self.compress_range, self.compress_mode
        use_ef = self.error_feedback
        sparse_ef = self._use_sparse_ef()
        ring_pad = self._ring_pad if bits is not None else 0
        margin = self._dense_margin
        policy = self.exchange_policy
        xbytes = self.exchange_bytes_per_step

        def dense_table_exchange(g):
            """SparCML's switch-over target: the table gradient as one
            dense buffer over the mean or the coded ring (no EF: it is
            the worst-case escape hatch)."""
            if bits is None:
                return collectives.pmean(mesh, g)
            flat = g.reshape(-1)
            length = flat.shape[0]
            padded = ((length + n - 1) // n) * n
            flat = torch.nn.functional.pad(flat, (0, padded - length))
            flat = collectives._ring_all_reduce_local(
                flat, mesh, n, average=True, compress_bits=bits,
                compress_range=crange, compress_mode=cmode)
            return flat[:length].reshape(g.shape)

        def pick(k, kpad, table):
            dim = math.prod(table.shape[1:])
            algo, _ = collectives.pick_exchange_algo(
                n, kpad, table.shape[0], dim, sparse_bits=bits,
                dense_bits=bits, margin=margin)
            if algo == "sparse_rs":
                not_yet_ported(f"{type(self).__name__} table {k!r}",
                               reduce_scatter_exchange=algo)
            return algo, dim

        def step(params, opt_state, batch):
            # batch arrives as this rank's rows: the dedup is per rank
            tables, dense, batch2, uids, rows = dedup_and_gather(
                spec, params, batch)
            # the static pick, first: a branch that is not ported raises on
            # every rank alike before any collective
            picks = {k: pick(k, uids[k].shape[0], tables[k]) for k in spec}
            rows = leaves_requiring_grad(rows)
            dense_leaves = leaves_requiring_grad(dense)
            loss = loss_fn({**dense_leaves, **rows}, batch2)
            loss.backward()
            g_rows, g_dense = grads_of(rows), grads_of(dense_leaves)
            accum = opt_state["accum"]
            with torch.no_grad():
                # replica losses are local means; their mean is the global
                loss = collectives.pmean(mesh, loss.detach())

                # -- dense leaves: Parallax's ring half ------------------
                new_res = opt_state["residual"] if bits is not None else None
                if bits is not None:
                    flat, unravel = collectives.ravel_tree(
                        g_dense, device=self.device)
                    length = flat.shape[0]
                    if length:
                        flat = torch.nn.functional.pad(
                            flat, (0, ring_pad - length))
                        if use_ef:
                            flat, new_res = collectives._ring_all_reduce_local(
                                flat, mesh, n, average=True,
                                compress_bits=bits, compress_range=crange,
                                residual=new_res, compress_mode=cmode)
                        else:
                            flat = collectives._ring_all_reduce_local(
                                flat, mesh, n, average=True,
                                compress_bits=bits, compress_range=crange,
                                compress_mode=cmode)
                        g_dense = unravel(flat[:length])
                else:
                    g_dense = tree_map(lambda g: collectives.pmean(mesh, g),
                                       g_dense)
                # post-exchange gradients are the same on every rank, so
                # the norm accumulated below is too
                gn2 = sum_squares(g_dense, device=self.device)
                updates, new_dense_state = tx.update(
                    g_dense, opt_state["dense"], dense)
                dense = {k: p + updates[k].to(p.dtype)
                         for k, p in dense.items()}

                # -- table leaves: the pick per table, id streams shared
                # within each (field tuple, algo) group ------------------
                for fields, keys in groups.items():
                    u = uids[keys[0]]
                    kpad = u.shape[0]
                    sub: Dict[str, list] = {}
                    for k in keys:
                        sub.setdefault(picks[k][0], []).append(k)
                    for algo, ks in sub.items():
                        if algo == "dense":
                            for k in ks:
                                policy[k] = "dense"
                                xbytes[k] = collectives.dense_ring_bytes(
                                    tables[k].shape[0], picks[k][1], n, bits)
                                with annotate(
                                        "sparse_tables/dense_exchange",
                                        table=k):
                                    g = torch.zeros_like(tables[k]) \
                                        .index_add_(0, u, g_rows[k])
                                    g = dense_table_exchange(g)
                                gn2 = gn2 + torch.sum(g * g)
                                # dense elementwise Adagrad: untouched rows
                                # have g == 0, neither weights nor accum move
                                with annotate("sparse_tables/apply"):
                                    acc = accum[k] + g * g
                                    tables[k].copy_(tables[k] - lr * g
                                                    * torch.rsqrt(acc + eps))
                                    accum[k].copy_(acc)
                            continue
                        with annotate("sparse_tables/sparse_exchange",
                                      tables=len(ks)):
                            _, uniq, inv = collectives._ag_gather_ids(u, mesh)
                        for i, k in enumerate(ks):
                            policy[k] = "sparse"
                            xbytes[k] = collectives.sparse_exchange_bytes(
                                n, kpad, picks[k][1], bits,
                                include_ids=(i == 0))
                            with annotate("sparse_tables/sparse_exchange",
                                          table=k):
                                all_rows, _ = collectives._ag_exchange_rows(
                                    g_rows[k], mesh, compress_bits=bits,
                                    compress_range=(crange if bits is not None
                                                    else 1.0),
                                    compress_mode=cmode,
                                    uids=u if sparse_ef else None,
                                    residual=(opt_state["sres"][k]
                                              if sparse_ef else None))
                            # the merge (and the mean) folded into the
                            # apply: merge_apply's merge mode, in place
                            with annotate("sparse_tables/apply"):
                                _, _, ssq = sparse_kernels.merge_apply(
                                    tables[k], accum[k], uniq, all_rows, inv,
                                    lr=lr, eps=eps, denom=float(n))
                            gn2 = gn2 + ssq
                params = {**dense, **tables}
                new_state = {"dense": new_dense_state, "accum": accum}
                if bits is not None:
                    new_state["residual"] = new_res
                if sparse_ef:
                    # the per-table carries were updated in place
                    new_state["sres"] = opt_state["sres"]
                # the health vector's third slot: the reduce-scatter
                # overflow count of the JAX step, 0 on the ported branches
                health = torch.cat([_health_pack(loss, torch.sqrt(gn2)),
                                    gn2.new_zeros(1)])
            return params, new_state, loss, health

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

    def _observe_scalars(self, hm, health) -> None:
        """The hybrid step's health vector carries a third slot, the JAX
        step's reduce-scatter overflow count: a nonzero count is surfaced
        (``trainer_rs_overflow_total``) instead of silently dropped."""
        vals = health.numpy()
        hm.observe(loss=float(vals[0]), grad_norm=float(vals[1]))
        if self._hybrid_dp and vals.shape[0] > 2 and vals[2] > 0:
            self.telemetry.inc("trainer_rs_overflow_total", int(vals[2]))
            obs.emit_event("rs_overflow", count=int(vals[2]))

    def _record_step(self, dt: float, batch, health=None) -> None:
        """CTRTrainer's per-step record plus, for the hybrid exchange, the
        per-table exchange counters and one ``exchange`` event per table
        the first time."""
        super()._record_step(dt, batch, health=health)
        policy, xbytes = self.exchange_policy, self.exchange_bytes_per_step
        if not (self._hybrid_dp and policy):
            return
        reg = self.telemetry
        for k, pol in policy.items():
            b = xbytes.get(k, 0)
            reg.inc(obs.labeled("trainer_exchange_bytes_total", table=k,
                                policy=pol), b)
            reg.inc(obs.labeled("trainer_exchange_algo_total", table=k,
                                algo=pol))
            reg.inc("trainer_sparse_exchange_bytes_total" if pol == "sparse"
                    else "trainer_dense_ring_bytes_total", b)
        if not self._exchange_logged:
            self._exchange_logged = True
            for k, pol in policy.items():
                obs.emit_event("exchange", table=k, policy=pol,
                               bytes_per_step=xbytes.get(k, 0))
