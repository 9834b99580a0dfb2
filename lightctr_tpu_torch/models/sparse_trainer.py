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
    mode: one kernel that merges and applies) — or over the
    reduce-scatter exchange: ids owner-partitioned by ``uid % n``, routed
    round the ring and merged at the owner (``dedup_ids`` cut at the
    shard capacity, then ``merge_rows`` and the mean per table), only the
    merged owner shards all-gathered and applied (``merge_apply``'s apply
    mode) — or, past the density switch, as a dense [vocab, ...] buffer
    over the mean or the coded ring; every rank applies the identical
    update, so replicas cannot diverge.  ``self.exchange_policy`` records
    the pick ({table: "sparse" | "sparse_rs" | "dense"});
  - reduce-scatter capacities are expected sizes with slack, so every
    global batch is checked on the host (``rs_fits``) before the step; a
    batch that would overflow runs the same step with the allgather in
    place of the reduce-scatter (counted in
    ``trainer_rs_fallback_total``).  Every rank is handed the same global
    batch, so every rank takes the same branch with no collective;
  - dense leaves ride the coded ring with ``compress_bits`` (EF-SGD
    residual and all, CTRTrainer's compressed path), the plain mean
    otherwise.

Every step variant (one device, the allgather exact and coded, the
reduce-scatter and its fallback) carries the model-quality sketch when
``quality_bins`` arms it: the forward's probabilities bucketed by
``obs.quality.quality_sketch`` (``merge_rows`` in slot order) and, under a
mesh, summed over the ranks.  ``fit`` takes a compiled shard cache or its
directory.

MULTI-HOST replicated data parallelism (``hier_exchange`` given — a
:class:`~lightctr_tpu_torch.dist.hier.HierExchangeClient`) runs the JAX
trainer's two-level exchange.  A host is one ``torch.distributed`` group
of ``local_n`` ranks (the mesh), each its own process; every rank of
every host is built with the same constructor call and handed its host's
batch:

  - program A, on every rank: per-rank grads, then the LOCAL merge over
    the host's group — a SUM (the global denominator comes after the
    wire), per id stream on the cheaper of the allgather (``dedup_ids``
    on the gathered ids, ``merge_rows``) and the reduce-scatter
    (``_hier_local_algo``); the dense leaves and the loss are summed in
    one flat all-reduce.  Local reduce-scatter capacities are checked on
    the host batch first and a batch that would overflow runs the
    allgather instead;
  - hop B, on local rank 0 only: one merged payload per host is pushed
    to the reduce shards and the cross-host union pulled (tables sharing
    an id stream ride one grouped frame), then broadcast to the host's
    other ranks, sizes first, then the payload.  A failed hop (a shard
    that will not answer, a pull withheld past ``pull_timeout_s``) is
    broadcast too, and every rank raises: none carries on with a stale
    union;
  - program C, on every rank: the global mean applied — the tables by
    ``merge_apply``'s apply mode on the pre-merged rows, the dense leaves
    by the optimizer.  Identical inputs everywhere, so every rank of
    every host ends identical.

PS-style ``param_shardings`` (tables row-sharded over the mesh's
``embed`` axis, ``embed.table.ShardedTable``; the JAX trainer's
single-program step under GSPMD) runs, one rank per process, the
reference's worker-to-PS-shard pull and push (pull.h:50-99,
distributed_algo_abst.h:176-280):

  - each rank dedups its data index's rows' ids once per id stream
    (``dedup_ids``) and pulls the touched rows from their owners over
    the embed axis (``embed.table.pull_rows``: the buckets and the rows
    routed by ``all_to_all_exchange``, each owner serving from its block
    with ``gather_rows``);
  - gradients are taken on the rows; the dense leaves are averaged over
    the ``data`` axis;
  - each table's row gradients for the ids this rank's block owns (the
    others' and the pads zeroed) are averaged over the ``data`` axis by
    ``sparse_all_reduce`` (``dedup_ids`` on the gathered ids, then
    ``merge_rows``), and applied to the block at local indices by
    ``merge_apply``'s apply mode.  No push crosses the embed axis: the
    members of an embed line hold the same rows, so each computes the
    same gradients and keeps the rows it owns.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.dist import collectives
from lightctr_tpu_torch.embed import table as table_mod
from lightctr_tpu_torch.models.ctr_trainer import (
    CTRTrainer,
    _health_pack,
    _host,
    global_norm,
    sum_squares,
)
from lightctr_tpu_torch.obs import health as health_mod
from lightctr_tpu_torch.ops import sparse_kernels
from lightctr_tpu_torch.optim.updaters import apply_updates, tree_map
from lightctr_tpu_torch.utils.profiling import annotate


def _hier_local_algo(n: int, kpad: int, vocab: int, dims,
                     force_ag: bool = False):
    """The ONE local ag-vs-rs comparison of the hierarchical exchange's
    in-host merge -> ``(algo, rs_caps, per_table_bytes)``.  Both the
    step and its host-side plan mirror call this, so the capacities the
    step uses and the ones ``_rs_batch_fits`` checks cannot drift.  The
    dense ring is not a candidate: the wire needs a sparse union.  Ids
    are priced once per stream (``include_ids`` on the first table
    only)."""
    ag = [collectives.sparse_exchange_bytes(n, kpad, d, include_ids=(i == 0))
          for i, d in enumerate(dims)]
    caps = collectives.rs_default_caps(n, kpad, vocab)
    rs = [collectives.sparse_rs_bytes(n, caps[0], caps[1], d,
                                      include_ids=(i == 0))
          for i, d in enumerate(dims)]
    if force_ag or sum(ag) <= sum(rs):
        return "sparse", None, ag
    return "sparse_rs", caps, rs


#: every ``trainer_*`` exchange series this module emits (the JAX module's
#: EXCHANGE_SERIES, as far as the ported branches emit them)
EXCHANGE_SERIES = (
    "trainer_exchange_bytes_total",      # {table, policy} bytes/step
    "trainer_exchange_algo_total",       # {table, algo} steps per decision
    "trainer_sparse_exchange_bytes_total",
    "trainer_sparse_rs_bytes_total",
    "trainer_dense_ring_bytes_total",
    "trainer_hier_wire_bytes_total",     # hierarchical: the wire hop, a host
    "trainer_hier_local_bytes_total",    # hierarchical: the in-host merge
    "trainer_hier_wire_packed_bytes_total",   # measured socket bytes/step
    "trainer_hier_wire_fp32_bytes_total",     # fp32 equiv of same payload
    "trainer_hier_wire_id_saved_bytes_total",  # shared-stream id savings
    "trainer_hier_wire_ef_mass",         # gauge: member EF residual mass
    # the streaming rendezvous: chunk fill is rows/capacity, the overlap
    # ratio 1 - blocked/push
    "trainer_hier_chunk_pushes_total",    # chunk frames dispatched
    "trainer_hier_chunk_rows_total",      # rows those chunks carried
    "trainer_hier_chunk_capacity_rows_total",  # rows the windows could hold
    "trainer_hier_overlap_push_seconds_total",   # dispatch->commit wall
    "trainer_hier_overlap_blocked_seconds_total",  # of which commit blocked
    "trainer_rs_fallback_total",
    "trainer_rs_overflow_total",
    # tiered device fast path (TieredDeviceEmbedding)
    "trainer_tiered_fast_steps_total",   # all-hot steps (no store surface)
    "trainer_tiered_fast_rows_total",    # rows through the in-place apply
    "trainer_tiered_pushed_rows_total",  # non-resident rows via push_batch
    "trainer_tiered_stale_tickets_total",  # adopt refused: residency moved
)

#: the byte counter of each sparse policy (the rest are the dense ring's)
_POLICY_BYTES = {"sparse": "trainer_sparse_exchange_bytes_total",
                 "sparse_rs": "trainer_sparse_rs_bytes_total",
                 "hier": "trainer_hier_wire_bytes_total"}


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
    hier_exchange: a :class:`~lightctr_tpu_torch.dist.hier.
        HierExchangeClient` (the same call on every rank; only local rank
        0's opens sockets) — arms the two-level exchange (module
        docstring).  Requires a mesh (the host's ranks), replicated params
        and ``compress_bits=None`` (the wire codec is the client's knob).
    resources / device_telemetry / quality_bins: CTRTrainer's planes, on
        every step variant (the fallback step included).
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
        resources: Optional[bool] = None,
        device_telemetry: Optional[bool] = None,
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
        self._eps = eps
        self._dense_margin = dense_switch_margin
        # mesh WITHOUT explicit shardings = replicated data parallelism:
        # the explicit hybrid exchange
        self._hybrid_dp = mesh is not None and param_shardings is None
        # hierarchical mode: the hybrid step is replaced by the local
        # merge, the wire hop and the apply (module docstring)
        self._hier = hier_exchange is not None
        if self._hier:
            if mesh is None or param_shardings is not None:
                raise ValueError(
                    "hier_exchange needs a mesh of replicated local "
                    "replicas (no param_shardings)")
            if compress_bits is not None:
                raise ValueError(
                    "hier_exchange owns its wire codec via the "
                    "HierExchangeClient knob (codec='f16'/'q8_ef'/"
                    "'q4_ef'); compress_bits must stay None")
            self._hybrid_dp = False
        # {table: "sparse" | "sparse_rs" | "dense"} — the pick each table
        # leaf got, and {table: bytes each rank transmits per step under
        # it}, written by the step with the accounting helpers of
        # dist.collectives
        self.exchange_policy: Dict[str, str] = {}
        self.exchange_bytes_per_step: Dict[str, int] = {}
        self._exchange_logged = False
        # the reduce-scatter's overflow fallback: the same step with the
        # allgather for its sparse_rs tables, built at its first use, which
        # records into its own dicts so it cannot shadow the primary
        # step's decisions
        self._step_ag = None
        self._fallback_policy: Dict[str, str] = {}
        self._fallback_bytes: Dict[str, int] = {}
        self._last_step_fallback = False
        self._fallback_logged = False
        self._plan_cache: Dict = {}
        # {table: distinct rows touched, a running total on the device}
        # and what of it the registry has (touched_rows, flush_health)
        self._touched: Dict[str, torch.Tensor] = {}
        self._touched_published: Dict[str, int] = {}
        # hierarchical-exchange state: the wire client, the per-step round
        # counter (every host's trainer steps in lockstep, so the counter
        # IS the round id), the fixed table-id order the rendezvous keys
        # rounds by, and the local-merge decisions (the allgather
        # fallback records separately); the wire's numbers of the last
        # step are local rank 0's, broadcast to the host's ranks
        self._hier_client = hier_exchange
        self._hier_epoch = 0
        self._hier_tables = list(self._spec)
        self.hier_local_policy: Dict[str, str] = {}
        self.hier_local_bytes_per_step: Dict[str, int] = {}
        self._hier_fb_local_policy: Dict[str, str] = {}
        self._hier_fb_local_bytes: Dict[str, int] = {}
        self._hier_last_local = False  # last step ran the ag fallback
        self._hier_wire_dense_bytes = 0
        self._hier_wire_packed_bytes = 0
        self._hier_wire_fp32_bytes = 0
        self._hier_wire_id_saved = 0
        self._hier_chunk_pushes = 0
        self._hier_chunk_rows = 0
        self._hier_chunk_capacity = 0
        self._hier_push_seconds = 0.0
        self._hier_blocked_seconds = 0.0
        super().__init__(
            params, logits_fn, cfg, l2_fn=l2_fn, fused_fn=fused_fn, mesh=mesh,
            param_shardings=param_shardings, compress_bits=compress_bits,
            compress_range=compress_range, compress_mode=compress_mode,
            error_feedback=error_feedback, quality_bins=quality_bins,
            resources=resources, device_telemetry=device_telemetry,
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
        local = table_mod.local_view(params)
        state = table_mod.place_like({
            "dense": self.tx.init({k: local[k] for k in dense}),
            "accum": {k: torch.zeros_like(local[k]) for k in self._spec},
        }, params)
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
        """The two-level exchange with ``hier_exchange``; replicated data
        parallelism takes the explicit hybrid exchange; one device keeps
        the O(touched) step."""
        if self._hier:
            return self._make_hier_step()
        if self._hybrid_dp:
            return self._make_hybrid_dp_step()
        if self.param_shardings is not None:
            return self._make_sharded_step()
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
    def _dedup_and_gather(spec, groups, params, batch, counts=None):
        """Steps 1-3 of the module recipe: per-stream batch-id dedup,
        position rewrite, and the O(touched) row gather.  Tables listing
        the IDENTICAL field tuple (``groups``, :meth:`_field_groups` of
        ``spec``) run the dedup once and share the resulting ``(uids,
        inv)``, so dedup work is paid per distinct id stream, not per
        table.  A ``counts`` dict gets each table's distinct count (B2's,
        a 0-d tensor on the device)."""
        with annotate("sparse_tables/dedup_gather", tables=len(spec),
                      id_streams=len(groups)):
            tables = {k: params[k] for k in spec}
            dense = {k: v for k, v in params.items() if k not in spec}
            batch2 = dict(batch)
            uids = {}
            for fields, keys in groups.items():
                ids = torch.cat(
                    [batch[f].reshape(-1) for f in fields]
                ).to(torch.int32)
                u, inv, n = sparse_kernels.dedup_ids(ids)
                for k in keys:
                    uids[k] = u
                    if counts is not None:
                        counts[k] = n
                ofs = 0
                for f in fields:
                    m = batch[f].numel()
                    batch2[f] = inv[ofs:ofs + m].reshape(batch[f].shape)
                    ofs += m
            rows = {k: tables[k].index_select(0, uids[k]) for k in spec}
        return tables, dense, batch2, uids, rows

    def _split_grads(self, grads):
        """(table rows' grads, dense leaves' grads) of one grad tree."""
        return ({k: g for k, g in grads.items() if k in self._spec},
                {k: g for k, g in grads.items() if k not in self._spec})

    def _make_step(self):
        grad_fn = self._make_grad_fn()
        tx = self.tx
        spec = self._spec
        lr, eps = self.cfg.learning_rate, self._eps
        dedup_and_gather = self._dedup_and_gather
        groups = self._field_groups(spec)

        def step(params, opt_state, batch):
            counts = {} if obs.enabled() else None
            tables, dense, batch2, uids, rows = dedup_and_gather(
                spec, groups, params, batch, counts)
            if counts:
                self._count_touched(counts)
            loss, probs, grads = grad_fn({**dense, **rows}, batch2)
            g_rows, g_dense = self._split_grads(grads)
            with annotate("trainer/optimizer"), torch.no_grad():
                # grad global norm over touched rows + dense leaves: the
                # health scalar (one reduction; fetched only when read)
                gnorm = global_norm({"rows": g_rows, "dense": g_dense})
                updates, new_dense_state = tx.update(
                    g_dense, opt_state["dense"], dense)
                dense = apply_updates(dense, updates)
                with annotate("sparse_tables/apply"):
                    for k in spec:
                        # in place on the table and its accumulator; the
                        # uids are unique apart from the id-0 pads, which
                        # carry zero gradient
                        sparse_kernels.merge_apply(
                            tables[k], opt_state["accum"][k], uids[k],
                            g_rows[k], None, lr=lr, eps=eps)
                params = {**dense, **tables}
                health = self._append_sketch(_health_pack(loss, gnorm),
                                             probs, batch2)
            return (params, {"dense": new_dense_state,
                             "accum": opt_state["accum"]},
                    loss, health)

        return step

    def _count_touched(self, counts) -> None:
        """Add each table's distinct count of the step to its running
        total on the device (no read: the step is not synchronised)."""
        with torch.no_grad():
            for k, n in counts.items():
                t = self._touched.get(k)
                if t is None:
                    self._touched[k] = n.to(torch.int64)
                else:
                    t.add_(n)

    def touched_rows(self) -> Dict[str, int]:
        """The distinct rows each table's steps touched, summed over the
        single-device steps run with telemetry on (B2's count of each
        step's id stream; reading it waits for the steps)."""
        return {k: int(t) for k, t in self._touched.items()}

    def flush_health(self) -> None:
        """CTRTrainer's drain, then the touched-row totals into the
        telemetry registry: ``embed_touched_rows_total{table=...}``."""
        super().flush_health()
        for k, n in self.touched_rows().items():
            delta = n - self._touched_published.get(k, 0)
            if delta:
                self.telemetry.inc(
                    obs.labeled("embed_touched_rows_total", table=k), delta)
            self._touched_published[k] = n

    def _make_hybrid_dp_step(self, force_ag: bool = False):
        """Replicated data-parallel step with the hybrid explicit exchange
        (module docstring): per-rank O(touched) grads, table leaves over
        the picked exchange (the sparse allgather, the reduce-scatter or,
        past the density switch, the dense mean/ring), dense leaves over
        the coded ring or the plain mean.  Tables sharing a field tuple
        share the exchanged id stream: only the first table of a
        (stream, algo, caps) group pays the id bytes.  ``force_ag`` builds
        the overflow fallback: ``sparse_rs`` picks take the allgather."""
        grad_fn = self._make_grad_fn()
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
        if force_ag:
            policy, xbytes = self._fallback_policy, self._fallback_bytes
        else:
            policy, xbytes = self.exchange_policy, self.exchange_bytes_per_step

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

        def pick(kpad, table):
            """(algo, dim, caps) of one table: the static pick from shapes,
            the allgather in the fallback, and the reduce-scatter's
            capacities."""
            vocab, dim = table.shape[0], math.prod(table.shape[1:])
            algo, _ = collectives.pick_exchange_algo(
                n, kpad, vocab, dim, sparse_bits=bits, dense_bits=bits,
                margin=margin)
            if force_ag and algo == "sparse_rs":
                algo = "sparse"
            caps = (collectives.rs_default_caps(n, kpad, vocab)
                    if algo == "sparse_rs" else None)
            return algo, dim, caps

        def step(params, opt_state, batch):
            # batch arrives as this rank's rows: the dedup is per rank
            tables, dense, batch2, uids, rows = dedup_and_gather(
                spec, groups, params, batch)
            picks = {k: pick(uids[k].shape[0], tables[k]) for k in spec}
            loss, probs, grads = grad_fn({**dense, **rows}, batch2)
            g_rows, g_dense = self._split_grads(grads)
            accum = opt_state["accum"]
            with annotate("trainer/optimizer"), torch.no_grad():
                # replica losses are local means; their mean is the global
                loss = collectives.pmean(mesh, loss)

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
                dense = apply_updates(dense, updates)

                # -- table leaves: the pick per table, id streams shared
                # within each (field tuple, algo, caps) group ------------
                # the reduce-scatter's overflow count of this rank (the
                # host check makes it 0; a nonzero sum reaches the health
                # vector instead of passing silently)
                over_total = None
                for fields, keys in groups.items():
                    u = uids[keys[0]]
                    kpad = u.shape[0]
                    sub: Dict[tuple, list] = {}
                    for k in keys:
                        sub.setdefault((picks[k][0], picks[k][2]),
                                       []).append(k)
                    for (algo, caps), ks in sub.items():
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
                        if algo == "sparse_rs":
                            bucket_cap, shard_cap = caps
                            with annotate("sparse_tables/rs_exchange",
                                          tables=len(ks),
                                          bucket_cap=bucket_cap,
                                          shard_cap=shard_cap):
                                dest, order, _, inv, out_ids, over = \
                                    collectives._rs_ids(
                                        u, mesh, n, bucket_cap, shard_cap)
                            over_total = (over if over_total is None
                                          else over_total + over)
                            for i, k in enumerate(ks):
                                policy[k] = "sparse_rs"
                                xbytes[k] = collectives.sparse_rs_bytes(
                                    n, bucket_cap, shard_cap, picks[k][1],
                                    bits, include_ids=(i == 0))
                                with annotate("sparse_tables/rs_exchange",
                                              table=k):
                                    out_rows = collectives._rs_gather_rows(
                                        g_rows[k], dest, order, inv, mesh, n,
                                        bucket_cap, shard_cap, average=True,
                                        compress_bits=bits,
                                        compress_range=(
                                            crange if bits is not None
                                            else 1.0),
                                        compress_mode=cmode,
                                        uids=u if sparse_ef else None,
                                        residual=(opt_state["sres"][k]
                                                  if sparse_ef else None))
                                    if sparse_ef:
                                        # the carry was updated in place
                                        out_rows = out_rows[0]
                                # rows arrived merged at their owners: the
                                # apply mode on the all-gathered shards
                                with annotate("sparse_tables/apply"):
                                    _, _, ssq = sparse_kernels.merge_apply(
                                        tables[k], accum[k], out_ids,
                                        out_rows, None, lr=lr, eps=eps)
                                gn2 = gn2 + ssq
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
                # overflow summed over the ranks (0 without a sparse_rs
                # table, which every rank knows without a collective)
                over_slot = (gn2.new_zeros(1) if over_total is None else
                             collectives.all_reduce(mesh, over_total)
                             .to(torch.float32).reshape(1))
                health = torch.cat([_health_pack(loss, torch.sqrt(gn2)),
                                    over_slot])
                # the quality sketch of the global batch: each rank's rows
                # summed over the ranks
                health = self._append_sketch(health, probs, batch2, mesh)
            return params, new_state, loss, health

        return step

    def _make_sharded_step(self):
        """The step of ``param_shardings`` (module docstring): per id
        stream one dedup; each table's touched rows pulled from their
        owners (a replicated table gathered locally); grads on the rows;
        the dense leaves and the loss averaged over the data axis; each
        table's owned row gradients averaged over the data axis by
        ``sparse_all_reduce`` and applied to this rank's block by
        ``merge_apply``'s apply mode at local indices."""
        grad_fn = self._make_grad_fn()
        tx = self.tx
        spec = self._spec
        lr, eps = self.cfg.learning_rate, self._eps
        groups = self._field_groups(spec)
        mesh = self.mesh
        emb = self.full_mesh.view("embed")
        view, rewrap = table_mod.local_view, table_mod.rewrap

        def step(params, opt_state, batch):
            tables = {k: params[k] for k in spec}
            dense = {k: v for k, v in params.items() if k not in spec}
            accum = opt_state["accum"]
            batch2 = dict(batch)
            uids, counts, rows = {}, {}, {}
            with annotate("sparse_tables/sharded_pull", tables=len(spec),
                          id_streams=len(groups)):
                for fields, keys in groups.items():
                    ids = torch.cat([batch[f].reshape(-1)
                                     for f in fields]).to(torch.int32)
                    u, inv, count = sparse_kernels.dedup_ids(ids)
                    ofs = 0
                    for f in fields:
                        m = batch[f].numel()
                        batch2[f] = inv[ofs:ofs + m].reshape(batch[f].shape)
                        ofs += m
                    for k in keys:
                        uids[k], counts[k] = u, count
                        t = tables[k]
                        rows[k] = (table_mod.pull_rows(t, u, count)
                                   if isinstance(t, table_mod.ShardedTable)
                                   else t.index_select(0, u))
            loss, probs, grads = grad_fn({**dense, **rows}, batch2)
            g_rows, g_dense = self._split_grads(grads)
            with annotate("trainer/optimizer"), torch.no_grad():
                loss = collectives.pmean(mesh, loss)
                g_dense = tree_map(lambda g: collectives.pmean(mesh, g),
                                   g_dense)
                gn2 = self._sharded_sumsq(g_dense, dense)
                updates, new_dense_state = tx.update(
                    g_dense, view(opt_state["dense"]), view(dense))
                dense = rewrap(apply_updates(view(dense), updates), dense)
                new_dense_state = table_mod.place_like(new_dense_state,
                                                       params)
                for k in spec:
                    t, a, u = tables[k], accum[k], uids[k]
                    sharded = isinstance(t, table_mod.ShardedTable)
                    block = t.local if sharded else t
                    lo = t.offset if sharded else 0
                    hi = lo + block.shape[0]
                    slot = torch.arange(u.shape[0], device=u.device)
                    owned = (slot < counts[k]) & (u >= lo) & (u < hi)
                    g = g_rows[k] * owned.to(g_rows[k].dtype).reshape(
                        (-1,) + (1,) * (g_rows[k].ndim - 1))
                    with annotate("sparse_tables/sharded_push", table=k):
                        union, merged = collectives.sparse_all_reduce(
                            mesh, u, g, average=True)
                    # the union's ids of this block at their local index,
                    # the rest (other blocks, the id-0 pads past slot 0)
                    # past the block, where the apply drops them; sorted,
                    # so a local 0 sits at slot 0 (the apply's pad rule)
                    pad = (union == 0) & (torch.arange(
                        union.shape[0], device=u.device) > 0)
                    mine = (union >= lo) & (union < hi) & ~pad
                    local, order = torch.sort(torch.where(
                        mine, union - lo, block.shape[0]).to(torch.int32))
                    with annotate("sparse_tables/apply", table=k):
                        _, _, ssq = sparse_kernels.merge_apply(
                            block, a.local if sharded else a, local,
                            merged.index_select(0, order), None, lr=lr,
                            eps=eps)
                    gn2 = gn2 + (collectives.all_reduce(emb, ssq)
                                 if sharded else ssq)
                params = {**dense, **tables}
                health = self._append_sketch(
                    _health_pack(loss, torch.sqrt(gn2)), probs, batch2, mesh)
            return (params, {"dense": new_dense_state, "accum": accum},
                    loss, health)

        return step

    # -- the hierarchical two-level exchange -------------------------------

    #: wire table id of the dense-leaf stream: dense gradients flatten to
    #: one [L] vector and ride the same rendezvous as dim-1 rows keyed by
    #: position, with the ranks' summed loss appended as the last entry
    #: (the cross-host loss mean needs a wire hop anyway — it shares this
    #: one).  Real tables use ids 0..len(spec)-1 in spec order.
    _HIER_DENSE_TABLE = 1 << 20

    def _make_hier_step(self, force_ag: bool = False):
        """The two-level step (module docstring): program A (per-rank
        grads, the in-host SUM merge per id stream on the cheaper of the
        allgather and the reduce-scatter, dense leaves and loss in one
        flat all-reduce), hop B (:meth:`_hier_wire`, local rank 0 then a
        broadcast), program C (the global mean applied by ``merge_apply``
        and the optimizer).  ``force_ag`` builds the overflow fallback:
        every local merge takes the allgather."""
        grad_fn = self._make_grad_fn()
        tx = self.tx
        spec = self._spec
        lr, eps = self.cfg.learning_rate, self._eps
        dedup_and_gather = self._dedup_and_gather
        groups = self._field_groups(spec)
        mesh = self.mesh
        n = mesh.size
        if force_ag:
            policy, xbytes = self._hier_fb_local_policy, \
                self._hier_fb_local_bytes
        else:
            policy, xbytes = self.hier_local_policy, \
                self.hier_local_bytes_per_step

        def step(params, opt_state, batch):
            # -- program A: this rank's rows of the host batch ----------
            tables, dense, batch2, uids, rows = dedup_and_gather(
                spec, groups, params, batch)
            loss, probs, grads = grad_fn({**dense, **rows}, batch2)
            g_rows, g_dense = self._split_grads(grads)
            accum = opt_state["accum"]
            with annotate("trainer/optimizer"), torch.no_grad():
                # dense grads + the rank's mean loss ride ONE flat sum:
                # [sum over local ranks of grads..., sum of losses]
                flat, unravel = collectives.ravel_tree(g_dense,
                                                       device=self.device)
                dense_flat = collectives.all_reduce(mesh, torch.cat(
                    [flat.to(torch.float32),
                     loss.reshape(1).to(torch.float32)]))
                over_total = torch.zeros((), dtype=torch.int32,
                                         device=self.device)
                out_ids: Dict = {}
                out_rows: Dict = {}
                for fields, keys in groups.items():
                    u = uids[keys[0]]
                    kpad = u.shape[0]
                    vocab = max(tables[k].shape[0] for k in keys)
                    dims = [math.prod(tables[k].shape[1:]) for k in keys]
                    # the SAME comparison the host-side plan mirror makes
                    algo, caps, per_bytes = _hier_local_algo(
                        n, kpad, vocab, dims, force_ag=force_ag)
                    if algo == "sparse":
                        with annotate("sparse_tables/hier_local",
                                      algo="sparse", tables=len(keys)):
                            _, uniq, inv = collectives._ag_gather_ids(u, mesh)
                            for i, k in enumerate(keys):
                                policy[k] = "sparse"
                                xbytes[k] = per_bytes[i]
                                all_rows, _ = collectives._ag_exchange_rows(
                                    g_rows[k], mesh)
                                out_ids[k] = uniq
                                out_rows[k] = sparse_kernels.merge_rows(
                                    all_rows, inv, uniq.shape[0])
                    else:
                        bucket_cap, shard_cap = caps
                        with annotate("sparse_tables/hier_local",
                                      algo="sparse_rs", tables=len(keys)):
                            dest, order, _, inv, ids_g, over = \
                                collectives._rs_ids(u, mesh, n, bucket_cap,
                                                    shard_cap)
                            over_total = over_total + over
                            for i, k in enumerate(keys):
                                policy[k] = "sparse_rs"
                                xbytes[k] = per_bytes[i]
                                out_ids[k] = ids_g
                                out_rows[k] = collectives._rs_gather_rows(
                                    g_rows[k], dest, order, inv, mesh, n,
                                    bucket_cap, shard_cap, average=False)
                over = collectives.all_reduce(mesh, over_total)

                # -- hop B: one merged payload per host ------------------
                payload, dsum = self._hier_wire(out_ids, out_rows,
                                                dense_flat)
                loss_v = float(dsum[-1])
                dense_mean = torch.from_numpy(
                    np.ascontiguousarray(dsum[:-1])).to(self.device)

                # -- program C: apply the global mean --------------------
                g_dense = unravel(dense_mean)
                gn2 = sum_squares(g_dense, device=self.device)
                updates, new_dense_state = tx.update(
                    g_dense, opt_state["dense"], dense)
                dense = apply_updates(dense, updates)
                with annotate("sparse_tables/apply"):
                    for k in spec:
                        gu, grows = payload[k]
                        # rows arrive merged: the apply mode, in place
                        _, _, ssq = sparse_kernels.merge_apply(
                            tables[k], accum[k], gu, grows, None,
                            lr=lr, eps=eps)
                        gn2 = gn2 + ssq
                loss_t = torch.tensor(loss_v, dtype=torch.float32,
                                      device=self.device)
                health = torch.cat([_health_pack(loss_t, torch.sqrt(gn2)),
                                    over.to(torch.float32).reshape(1)])
                # the quality sketch of the HOST's batch (summed over its
                # ranks); the wire never carries it
                health = self._append_sketch(health, probs, batch2, mesh)
            return ({**dense, **tables},
                    {"dense": new_dense_state, "accum": accum},
                    loss_t, health)

        return step

    def _hier_local_plan(self, batch) -> Dict[str, tuple]:
        """Host-side mirror of the step's per-stream local algo choice —
        the same :func:`_hier_local_algo` call, cached per batch-shape
        signature, shaped like :meth:`_exchange_plan` so
        :meth:`_rs_batch_fits` (over the host's ranks) can consume it."""
        n = self.mesh.size
        groups = self._field_groups(self._spec)
        sig = ("hier",) + tuple(
            (fields, tuple(tuple(np.shape(batch[f])) for f in fields))
            for fields in groups)
        plan = self._plan_cache.get(sig)
        if plan is not None:
            return plan
        plan = {}
        for fields, keys in groups.items():
            kpad = sum(int(np.prod(np.shape(batch[f]))) for f in fields) // n
            vocab = max(int(self.params[k].shape[0]) for k in keys)
            dims = [math.prod(self.params[k].shape[1:]) for k in keys]
            algo, caps, _ = _hier_local_algo(n, kpad, vocab, dims)
            for k in keys:
                plan[k] = (fields, algo, caps)
        self._plan_cache[sig] = plan
        return plan

    @staticmethod
    def _hier_strip_plan(uids: np.ndarray):
        """The ONE copy of the wire-facing pad-strip convention ->
        ``(real mask, sort order over the real entries)``: drop id-0
        repeats beyond slot 0 — slot 0 survives whether id 0 is real or
        the conventional fill (a zero row there is a no-op on both the
        wire merge and the apply) — then sort globally (the
        reduce-scatter local merge emits per-owner-sorted shards).
        Tables sharing one id stream apply the same plan to each of
        their row payloads."""
        real = ~((uids == 0) & (np.arange(len(uids)) > 0))
        order = np.argsort(uids[real], kind="stable")
        return real, order

    @staticmethod
    def _hier_strip_pads(uids: np.ndarray, rows: np.ndarray):
        """Collapse a dedup-convention (uids, rows) pair to its real
        entries, globally sorted (:meth:`_hier_strip_plan`)."""
        real, order = SparseTableCTRTrainer._hier_strip_plan(uids)
        return uids[real][order], rows[real][order]

    @staticmethod
    def _hier_pad(uids: np.ndarray, rows: np.ndarray):
        """Pad a sorted-unique wire result back into the dedup convention
        at the next power of two (a bounded shape family for the apply):
        id-0 fill, zero rows."""
        m = len(uids)
        size = 1 << max(3, (max(m, 1) - 1).bit_length())
        u = np.zeros(size, np.int32)
        u[:m] = uids.astype(np.int32)
        r = np.zeros((size,) + rows.shape[1:], np.float32)
        r[:m] = rows
        return u, r

    #: the int64 header local rank 0 broadcasts after the wire hop:
    #: [ok, dense entries, socket bytes, fp32-equivalent bytes, saved id
    #: bytes, chunk pushes, chunk rows, chunk capacity, push us, blocked
    #: us], then (pushed entries, pulled union) per id stream
    _HIER_HEAD = 10

    def _hier_wire(self, out_ids, out_rows, dense_flat):
        """Hop B of one step -> ``(payload, dsum)``: ``payload`` {table:
        (uids, rows)} the cross-host union padded into the dedup
        convention, rows divided by the global rank count, on this rank's
        device; ``dsum`` the float32 [L + 1] dense mean with the mean
        loss last.  Local rank 0 pushes and pulls (:meth:`_hier_hop`);
        it then broadcasts a header (sizes, or the failure), then the
        pulled ids and values, over the host's group, and every rank
        builds the same payload from them."""
        from lightctr_tpu_torch.dist.collectives import hier_wire_bytes

        client = self._hier_client
        mesh = self.mesh
        total = mesh.size * client.n_hosts
        wire_bits = {"f32": None, "f16": 16, "q8_ef": 8,
                     "q4_ef": 4}[client.codec]
        epoch = self._hier_epoch
        self._hier_epoch += 1
        groups = list(self._field_groups(self._spec).items())
        dims = {k: math.prod(self.params[k].shape[1:]) for k in self._spec}
        sw = self.stepwatch
        if sw is not None:
            # the phase a stalled rendezvous wedges in
            sw.mark("exchange")
        head = np.zeros(self._HIER_HEAD + 2 * len(groups), np.int64)
        pulled = err = None
        if mesh.rank == 0:
            try:
                pulled = self._hier_hop(out_ids, out_rows, dense_flat, epoch,
                                        groups, head)
                head[0] = 1
            except Exception as e:  # carried to the host's other ranks
                err = e
        head_t = self._hier_bcast(torch.from_numpy(head))
        head = head_t.numpy()
        if not head[0]:
            if err is not None:
                raise err
            raise RuntimeError(
                f"hierarchical exchange round {epoch}: the wire hop failed "
                "on local rank 0 of this host")
        n_dense = int(head[1])
        sizes = head[self._HIER_HEAD:].reshape(-1, 2)
        n_ids = int(sizes[:, 1].sum())
        n_vals = n_dense + sum(
            int(sizes[g, 1]) * sum(dims[k] for k in keys)
            for g, (_, keys) in enumerate(groups))
        if mesh.rank == 0:
            g_parts, d_r = pulled
            ids = np.concatenate([gu for gu, _ in g_parts] + [
                np.zeros(0, np.int64)]).astype(np.int64)
            vals = np.concatenate(
                [r.reshape(-1) for _, rs in g_parts for r in rs]
                + [d_r.reshape(-1)]).astype(np.float32)
        else:
            ids = np.zeros(n_ids, np.int64)
            vals = np.zeros(n_vals, np.float32)
        ids = self._hier_bcast(torch.from_numpy(ids)).numpy()
        vals = self._hier_bcast(torch.from_numpy(vals)).numpy()
        payload = {}
        io = vo = 0
        for g, (_, keys) in enumerate(groups):
            k_out, k_in = int(sizes[g, 0]), int(sizes[g, 1])
            g_u = ids[io:io + k_in]
            io += k_in
            for i, k in enumerate(keys):
                d = dims[k]
                r = vals[vo:vo + k_in * d]
                vo += k_in * d
                self.exchange_policy[k] = "hier"
                # the byte model prices the codec at its wire_bits and the
                # shared stream's ids ONCE per group
                self.exchange_bytes_per_step[k] = hier_wire_bytes(
                    k_out, k_in, d, wire_bits, include_ids=(i == 0))
                pu, pr = self._hier_pad(
                    g_u, r.reshape((k_in,) + tuple(self.params[k].shape[1:]))
                    / total)
                payload[k] = (torch.from_numpy(pu).to(self.device),
                              torch.from_numpy(pr).to(self.device))
        dsum = vals[vo:vo + n_dense] / total
        self._hier_wire_dense_bytes = hier_wire_bytes(n_dense, n_dense, 1,
                                                      None)
        (self._hier_wire_packed_bytes, self._hier_wire_fp32_bytes,
         self._hier_wire_id_saved, self._hier_chunk_pushes,
         self._hier_chunk_rows, self._hier_chunk_capacity) = (
            int(v) for v in head[2:8])
        self._hier_push_seconds = float(head[8]) * 1e-6
        self._hier_blocked_seconds = float(head[9]) * 1e-6
        if sw is not None:
            sw.mark("apply")
        return payload, dsum

    def _hier_bcast(self, t: torch.Tensor) -> torch.Tensor:
        """Local rank 0's ``t`` (a CPU tensor) on every rank of the host's
        group: staged on the card for an NCCL group, as it is for gloo."""
        mesh = self.mesh
        if mesh.size == 1:
            return t
        buf = t.to(mesh.device) if mesh.backend == "nccl" else t
        torch.distributed.broadcast(buf, src=mesh.global_rank(0),
                                    group=mesh.group)
        return buf.cpu()

    def _hier_hop(self, out_ids, out_rows, dense_flat, epoch, groups,
                  head):
        """The wire half on local rank 0: push the host's merged payload
        (tables sharing an id stream as one grouped frame, the dense+loss
        stream exact fp32 whatever the codec), commit, pull the unions.
        Returns ``([(union uids, [rows per table]) per group], dense
        sums)`` and fills ``head`` with the sizes and the step's wire
        numbers."""
        from lightctr_tpu_torch.dist.collectives import hier_wire_bytes

        client = self._hier_client
        table_id = {k: ti for ti, k in enumerate(self._hier_tables)}
        sock0 = client.bytes_sent + client.bytes_received
        saved0 = client.shared_id_saved_bytes
        chunk0 = (client.chunk_pushes_total, client.chunk_rows_total,
                  client.chunk_capacity_rows_total)
        fp32_equiv = 0
        out = []
        with annotate("sparse_tables/hier_wire", tables=len(self._spec),
                      epoch=epoch):
            # every group's push is DISPATCHED to its stripe pipelines,
            # and one commit joins them right before the first pull
            t_dispatch0 = time.perf_counter()
            pushed = []
            for fields, keys in groups:
                u = out_ids[keys[0]].cpu().numpy()
                real, order = self._hier_strip_plan(u)
                su = u[real][order]
                rows_g = [out_rows[k].cpu().numpy().reshape(len(u), -1)
                          [real][order] for k in keys]
                tids = [table_id[k] for k in keys]
                dims = [r.shape[1] for r in rows_g]
                if len(keys) == 1:
                    client.push_async(tids[0], su, rows_g[0], epoch)
                else:
                    client.push_group_async(tids, su, rows_g, epoch)
                pushed.append((tids, dims, len(su)))
            dvec = dense_flat.cpu().numpy().astype(np.float32).reshape(-1, 1)
            client.push_async(self._HIER_DENSE_TABLE,
                              np.arange(len(dvec), dtype=np.int64), dvec,
                              epoch, exact=True)
            t_commit0 = time.perf_counter()
            client.commit()
            t_done = time.perf_counter()
            for g, (tids, dims, k_out) in enumerate(pushed):
                if len(tids) == 1:
                    g_u, r = client.pull(tids[0], epoch, dims[0])
                    rows_out = [r]
                else:
                    g_u, rows_out = client.pull_group(tids, epoch, dims)
                for d in dims:
                    fp32_equiv += hier_wire_bytes(k_out, len(g_u), d)
                head[self._HIER_HEAD + 2 * g] = k_out
                head[self._HIER_HEAD + 2 * g + 1] = len(g_u)
                out.append((np.asarray(g_u, np.int64),
                            [np.asarray(x, np.float32) for x in rows_out]))
            d_u, d_r = client.pull(self._HIER_DENSE_TABLE, epoch, 1,
                                   exact=True)
            fp32_equiv += hier_wire_bytes(len(dvec), len(d_u), 1, None)
        head[1] = len(d_u)
        head[2] = client.bytes_sent + client.bytes_received - sock0
        head[3] = fp32_equiv
        head[4] = client.shared_id_saved_bytes - saved0
        head[5] = client.chunk_pushes_total - chunk0[0]
        head[6] = client.chunk_rows_total - chunk0[1]
        head[7] = client.chunk_capacity_rows_total - chunk0[2]
        head[8] = int((t_done - t_dispatch0) * 1e6)
        head[9] = int((t_done - t_commit0) * 1e6)
        return out, np.asarray(d_r, np.float32)

    # -- the reduce-scatter's capacity plan and overflow fallback --------

    def _exchange_plan(self, batch) -> Dict[str, tuple]:
        """The step's pick, made on the host: {table: (fields, algo,
        caps)} from the global batch's shapes through the same
        ``pick_exchange_algo`` / ``rs_default_caps`` calls the step makes
        on this rank's rows.  Cached per field-shape signature."""
        n = self.mesh.size
        groups = self._field_groups(self._spec)
        sig = tuple((fields, tuple(tuple(np.shape(batch[f])) for f in fields))
                    for fields in groups)
        plan = self._plan_cache.get(sig)
        if plan is not None:
            return plan
        plan = {}
        for fields, keys in groups.items():
            kpad = sum(int(np.prod(np.shape(batch[f]))) for f in fields) // n
            for k in keys:
                vocab = int(self.params[k].shape[0])
                dim = math.prod(self.params[k].shape[1:])
                algo, _ = collectives.pick_exchange_algo(
                    n, kpad, vocab, dim, sparse_bits=self.compress_bits,
                    dense_bits=self.compress_bits, margin=self._dense_margin)
                caps = (collectives.rs_default_caps(n, kpad, vocab)
                        if algo == "sparse_rs" else None)
                plan[k] = (fields, algo, caps)
        self._plan_cache[sig] = plan
        return plan

    def _rs_batch_fits(self, batch, plan) -> bool:
        """Exact capacity check of the global host batch for the plan's
        reduce-scatter tables (``rs_fits`` over each rank's raw ids, as
        :func:`~lightctr_tpu_torch.core.mesh.shard_batch` will cut them:
        one host unique a rank per distinct id stream).  Every rank holds
        the same global batch, so every rank decides alike."""
        by_stream: Dict[tuple, set] = {}
        for fields, algo, caps in plan.values():
            if algo == "sparse_rs":
                by_stream.setdefault(fields, set()).add(caps)
        n = self.mesh.size
        for fields, cap_set in by_stream.items():
            cols = [_host(batch[f]) for f in fields]
            per_member = [
                np.concatenate([c[m * (c.shape[0] // n):
                                  (m + 1) * (c.shape[0] // n)].reshape(-1)
                                for c in cols])
                for m in range(n)]
            for bucket_cap, shard_cap in cap_set:
                if not collectives.rs_fits(per_member, n, bucket_cap,
                                           shard_cap):
                    return False
        return True

    def _needs_fallback(self, batch) -> bool:
        """True when the batch would overflow a reduce-scatter table's
        capacities, counted in ``trainer_rs_fallback_total``: the global
        batch of the hybrid exchange, the host's batch of the two-level
        exchange's local merge (hosts need not agree: the wire payload is
        the same either way)."""
        if self._hier:
            fits = self._rs_batch_fits(batch, self._hier_local_plan(batch))
            self._hier_last_local = not fits
        elif self._hybrid_dp:
            fits = self._rs_batch_fits(batch, self._exchange_plan(batch))
        else:
            return False
        if fits:
            return False
        self.telemetry.inc("trainer_rs_fallback_total")
        return True

    @contextlib.contextmanager
    def _fallback_step(self):
        """Run the steps inside with the fallback step (``sparse_rs``
        tables on the allgather), built at its first use."""
        if self._step_ag is None:
            self._step_ag = (self._make_hier_step(force_ag=True)
                             if self._hier else
                             self._make_hybrid_dp_step(force_ag=True))
        primary, self._step = self._step, self._step_ag
        try:
            yield
        finally:
            self._step = primary

    def _prefetch_prepare(self):
        # the exchange planner (_exchange_plan / _rs_batch_fits) and the
        # health feed read HOST ids before the step, so a prefetch stage
        # hands this trainer host batches: it overlaps the parse only, and
        # the step keeps its own _put
        return None

    def train_step(self, batch, **kw) -> torch.Tensor:
        # decided from the caller's global batch, before this rank takes
        # its rows: a rank that decided from its own rows could take the
        # other exchange than its peers and wait on them forever
        self._last_step_fallback = self._needs_fallback(batch)
        if not self._last_step_fallback:
            return super().train_step(batch, **kw)
        with self._fallback_step():
            return super().train_step(batch, **kw)

    def fit(self, arrays, epochs=None, batch_size=None, eval_arrays=None,
            eval_every=0, verbose=False, prefetch=None):
        # the full-batch path steps self._step itself; minibatches go
        # through train_step, which checks each batch.  A shard cache is
        # loaded first, so the check reads its rows
        arrays = self._resolve_arrays(arrays)
        kw = dict(epochs=epochs, batch_size=batch_size,
                  eval_arrays=eval_arrays, eval_every=eval_every,
                  verbose=verbose, prefetch=prefetch)
        if batch_size is None and self._needs_fallback(arrays):
            with self._fallback_step():
                return super().fit(arrays, **kw)
        return super().fit(arrays, **kw)

    def fit_fullbatch_scan(self, arrays, epochs):
        if self._hier:
            raise ValueError(
                "the hierarchical exchange steps through a host wire hop "
                "and cannot ride lax.scan; use fit()/train_step()")
        arrays = self._resolve_arrays(arrays)
        if self._needs_fallback(arrays):
            with self._fallback_step():
                return super().fit_fullbatch_scan(arrays, epochs)
        return super().fit_fullbatch_scan(arrays, epochs)

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
        (``trainer_rs_overflow_total``) instead of silently dropped.
        Anything past the head scalars is the quality sketch (when armed),
        so the overflow slot is addressed by step family, not by
        length."""
        vals = health.numpy()
        if hm is not None:
            hm.observe(loss=float(vals[0]), grad_norm=float(vals[1]))
        head = 3 if (self._hybrid_dp or self._hier) else 2
        if head == 3 and vals.shape[0] > 2 and vals[2] > 0:
            self.telemetry.inc("trainer_rs_overflow_total", int(vals[2]))
            obs.emit_event("rs_overflow", count=int(vals[2]))
        self._feed_quality(vals, head)

    def _record_step(self, dt: float, batch, health=None) -> None:
        """CTRTrainer's per-step record plus, for the hybrid exchange, the
        per-table exchange counters of the step that ran (the fallback's
        own dicts after a fallback step) and one ``exchange`` event per
        table the first time each of the two steps runs."""
        super()._record_step(dt, batch, health=health)
        # the two-level exchange's wire policy is "hier" whichever local
        # merge ran (its fallback records the local dicts only)
        fallback = self._last_step_fallback and not self._hier
        policy, xbytes = ((self._fallback_policy, self._fallback_bytes)
                          if fallback else
                          (self.exchange_policy, self.exchange_bytes_per_step))
        if not ((self._hybrid_dp or self._hier) and policy):
            return
        reg = self.telemetry
        for k, pol in policy.items():
            b = xbytes.get(k, 0)
            reg.inc(obs.labeled("trainer_exchange_bytes_total", table=k,
                                policy=pol), b)
            reg.inc(obs.labeled("trainer_exchange_algo_total", table=k,
                                algo=pol))
            reg.inc(_POLICY_BYTES.get(pol, "trainer_dense_ring_bytes_total"),
                    b)
        if self._hier:
            # the dense+loss stream rides the wire once a step too, and
            # the in-host merge has its own counter (the local merge that
            # ran records its own dicts); then the wire's measured socket
            # bytes against the fp32 equivalent of the same payload, the
            # id bytes the shared streams saved, the member EF mass, and
            # the streaming rendezvous' chunk fill and overlap
            reg.inc("trainer_hier_wire_bytes_total",
                    self._hier_wire_dense_bytes)
            lb = (self._hier_fb_local_bytes if self._hier_last_local
                  else self.hier_local_bytes_per_step)
            reg.inc("trainer_hier_local_bytes_total", sum(lb.values()))
            reg.inc("trainer_hier_wire_packed_bytes_total",
                    self._hier_wire_packed_bytes)
            reg.inc("trainer_hier_wire_fp32_bytes_total",
                    self._hier_wire_fp32_bytes)
            reg.inc("trainer_hier_wire_id_saved_bytes_total",
                    self._hier_wire_id_saved)
            reg.gauge_set("trainer_hier_wire_ef_mass",
                          self._hier_client.carry_mass())
            reg.inc("trainer_hier_chunk_pushes_total",
                    self._hier_chunk_pushes)
            reg.inc("trainer_hier_chunk_rows_total", self._hier_chunk_rows)
            reg.inc("trainer_hier_chunk_capacity_rows_total",
                    self._hier_chunk_capacity)
            reg.inc("trainer_hier_overlap_push_seconds_total",
                    self._hier_push_seconds)
            reg.inc("trainer_hier_overlap_blocked_seconds_total",
                    self._hier_blocked_seconds)
        flag = "_fallback_logged" if fallback else "_exchange_logged"
        if not getattr(self, flag):
            setattr(self, flag, True)
            for k, pol in policy.items():
                obs.emit_event("exchange", table=k, policy=pol,
                               bytes_per_step=xbytes.get(k, 0),
                               fallback=fallback)


# =========================================================================
# Device-resident tiered-store fast path
# =========================================================================


class TieredDeviceEmbedding:
    """Hot-resident fast path binding an in-process
    :class:`~lightctr_tpu_torch.embed.tiered.TieredEmbeddingStore`'s pinned
    device pair to the kernel chain (the JAX module's class of the same
    name).

    Per step: :meth:`gather` probes the store's SLOT TICKETS
    (``hot_slots`` + ``res_epoch``) for the batch's unique cover — when
    every id is hot-resident the forward rows are ONE ``gather_rows``
    launch off the pinned block (no store surface call, no host row
    traffic); any miss falls back to the authoritative ``pull_batch``
    (creates, admission, promotion, SSP) and only the still-non-resident
    rows ride host memory.  :meth:`apply` then runs the batch's gradient
    rows through ONE ``merge_apply`` launch (merge mode: segment merge +
    mean scale + health sumsq + adagrad apply) IN PLACE on the store's
    ``(rows, accums)`` pair, so the pull → dedup → gather → grad → merge
    → apply chain for hot-resident uids never leaves the device, and
    reports the touched slots through ``adopt_device_tables`` (pinned to
    the gather's ``res_epoch``: residency moved underneath means the
    tickets were stale and the adopt fails loud instead of marking dead
    slots).  Non-resident ids push their merged gradients through
    ``push_batch`` (the store applies its exact in-place math wherever
    the row lives).

    Single-writer by contract: between a ``gather`` and its ``apply``
    nothing else may mutate the store (the apply writes the live block —
    a concurrent residency change is unrecoverable, which is why the
    apply checks the epoch first and the adopt is epoch-guarded).  The
    all-hot trajectory is bit-identical to the same ``merge_apply`` over
    a dense table given the same uids, rows and segment map (the fast
    path's parity oracle); mixed batches update miss rows with the
    store's correctly-rounded op-by-op math instead — each per-row step
    is the same adagrad recipe within the kernel's documented ulp.

    ``prefetch_next(ids)`` forwards the NEXT batch's unique cover to
    ``dispatch_prefetch`` so a miss-bearing pull commits off the staged
    plan instead of faulting synchronously.
    """

    def __init__(self, store, worker_id: int = 0, denom: float = 1.0,
                 registry=None):
        if not getattr(store, "device_hot", False):
            raise ValueError(
                "TieredDeviceEmbedding needs a device_hot store "
                "(TieredEmbeddingStore(device_hot=True))"
            )
        if store.updater != "adagrad":
            raise ValueError(
                "the fused merge_apply kernel is the sparse-adagrad "
                f"recipe; store updater {store.updater!r} unsupported"
            )
        self.store = store
        self.device = store.device
        self.worker_id = int(worker_id)
        self.denom = float(denom)
        self.dim = int(store.dim)
        self.registry = registry if registry is not None else store.registry
        self.epoch = 0
        self.fast_steps = 0
        self.mixed_steps = 0
        self.stale_tickets = 0
        self._fused = {}
        # single-writer discipline vs the store's OWN prefetch worker:
        # a dispatch runs speculative admission (residency moves!) on a
        # background thread, so no dispatch may be in flight while a
        # slot ticket is outstanding — gather() drains the queue before
        # ticketing, and prefetch_next() defers its dispatch to the end
        # of the matching apply()
        self._ticket_open = False
        self._deferred_prefetch = None

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    # -- forward: pull -> dedup -> gather -------------------------------------

    def gather(self, ids):
        """Batch ids (any shape, duplicates welcome) -> ``(rows_u
        [U, dim] tensor, inv [M] int32 tensor, ticket)``: the deduped row
        cover on the device plus the position map (``rows_u[inv]`` is the
        per-position view) and the slot ticket :meth:`apply` consumes."""
        ids_arr = np.ascontiguousarray(
            np.asarray(ids).reshape(-1), np.int64)
        uniq, inv = np.unique(ids_arr, return_inverse=True)
        store = self.store
        # no staging may run while the ticket is live (speculative
        # admission moves residency under the slot map — unrecoverable
        # once the apply has written the pair).  A wedged worker must
        # fail HERE, before any ticket exists
        if not store.prefetch_wait(timeout=30.0):
            raise RuntimeError(
                "prefetch worker failed to drain within 30s — refusing "
                "to open slot tickets over an in-flight stage"
            )
        self._ticket_open = True
        slots = store.hot_slots(uniq)
        pulled = None
        if (slots < 0).any() or not len(uniq):
            pulled = store.pull_batch(uniq, self.epoch, self.worker_id)
            if pulled is None:
                raise RuntimeError(
                    "tiered pull withheld (SSP gate) — the adapter is "
                    "single-worker; advance the straggler first"
                )
            slots = store.hot_slots(uniq)
        epoch = store.res_epoch
        hot = slots >= 0
        u = len(uniq)
        up = sparse_kernels.next_pow2(max(u, 1))
        sp = np.zeros(up, np.int32)
        sp[:u][hot] = slots[hot]
        w, _ = store.device_tables()
        rows_u = sparse_kernels.gather_rows(w, self._put(sp))[:u]
        if not hot.all():
            midx = np.flatnonzero(~hot)
            rows_u.index_copy_(0, self._put(midx),
                               self._put(pulled[midx].astype(np.float32)))
        ticket = {
            "uniq": uniq, "inv": inv, "slots": slots, "hot": hot,
            "res_epoch": epoch,
        }
        return rows_u, self._put(inv.astype(np.int32)), ticket

    # -- backward: grad -> merge -> apply -------------------------------------

    def _fused_fn(self, key):
        fn = self._fused.get(key)
        if fn is None:
            store = self.store
            lr, eps, denom = store.lr, store.eps, self.denom

            def f(w, a, uids, rows, seg):
                return sparse_kernels.merge_apply(
                    w, a, uids, rows, seg, lr=lr, eps=eps, denom=denom)

            # device-plane in-place check (obs/device.py): a table that
            # silently COPIED instead of updating in place doubles device
            # memory — no-op wrapper unless LIGHTCTR_DEVICE armed
            fn = obs.device.verify_donation(
                f"merge_apply_{key[0]}x{key[1]}", f, donate_argnums=(0, 1))
            self._fused[key] = fn
        return fn

    def apply(self, ticket, grad_rows):
        """Apply the step's per-position gradient rows ``[M, dim]``
        (aligned with the ``ids`` stream :meth:`gather` deduped; tensor
        or numpy).  Hot-resident rows ride the in-place merge_apply; the
        rest push through the store surface.  Returns the merged hot
        rows' sum of squares (the health gradient-norm feed; a 0-d tensor
        on the device, 0.0 when nothing was hot).  Bumps the adapter's
        SSP epoch — one gather/apply pair per step."""
        store = self.store
        uniq, inv, slots = ticket["uniq"], ticket["inv"], ticket["slots"]
        hot = ticket["hot"]
        u = len(uniq)
        telem = obs.enabled()
        reg = self.registry
        if store.res_epoch != ticket["res_epoch"]:
            # tickets went stale before the apply ran: the WHOLE batch can
            # still take the authoritative surface
            self.stale_tickets += 1
            if telem:
                reg.inc("trainer_tiered_stale_tickets_total")
            hot = np.zeros(u, bool)
        ssq = 0.0
        m = int(inv.shape[0])
        n_hot = int(hot.sum())
        if torch.is_tensor(grad_rows):
            g = grad_rows.to(self.device, torch.float32).reshape(m, self.dim)
        else:
            g = self._put(np.asarray(grad_rows, np.float32).reshape(
                m, self.dim))
        if n_hot:
            hs = slots[hot].astype(np.int64)
            order = np.argsort(hs)
            sp = sparse_kernels.next_pow2(n_hot)
            uids_p = np.zeros(sp, np.int32)
            uids_p[:n_hot] = hs[order]
            # unique index -> merge segment (sorted-slot position); miss
            # and padding positions land in a pad segment whose rows are
            # zeroed below, so their merged sum is exactly zero
            seg_of = np.full(u, sp - 1, np.int32)
            seg_of[np.flatnonzero(hot)[order]] = np.arange(
                n_hot, dtype=np.int32)
            mp = sparse_kernels.next_pow2(m)
            mask = self._put(hot[inv].astype(np.float32))[:, None]
            rows_p = torch.zeros((mp, self.dim), dtype=torch.float32,
                                 device=self.device)
            rows_p[:m] = g * mask
            inv_p = np.full(mp, sp - 1, np.int32)
            inv_p[:m] = seg_of[inv]
            w, a = store.device_tables()
            fused = self._fused_fn((sp, mp))
            uids_t, inv_t = self._put(uids_p), self._put(inv_p)
            # register the program with the process catalog (specs
            # captured BEFORE the call — the tables are written in place)
            obs.device.offer(f"merge_apply_{sp}x{mp}", fused,
                             (w, a, uids_t, rows_p, inv_t))
            w2, a2, ssq = fused(w, a, uids_t, rows_p, inv_t)
            store.adopt_device_tables(
                w2, a2, touched_slots=hs,
                expect_res_epoch=ticket["res_epoch"])
            if telem:
                reg.inc("trainer_tiered_fast_rows_total", n_hot)
        miss = ~hot
        if miss.any():
            g_np = g.cpu().numpy()
            gm = np.zeros((u, self.dim), np.float32)
            np.add.at(gm, inv, g_np)
            keys = uniq[miss]
            store.push_batch(self.worker_id, keys,
                             gm[miss] / self.denom, self.epoch)
            self.mixed_steps += 1
            if telem:
                reg.inc("trainer_tiered_pushed_rows_total", len(keys))
        else:
            self.fast_steps += 1
            if telem:
                reg.inc("trainer_tiered_fast_steps_total")
        self.epoch += 1
        self._ticket_open = False
        if self._deferred_prefetch is not None:
            nxt, self._deferred_prefetch = self._deferred_prefetch, None
            store.dispatch_prefetch(nxt)
        return ssq

    # -- overlapped fault prefetch -------------------------------------------

    def prefetch_next(self, ids) -> int:
        """Stage the NEXT batch's miss payloads behind this step
        (``dispatch_prefetch`` on the batch's unique cover — exactly the
        key stream the matching pull will carry).  Called between a
        gather and its apply, the dispatch is DEFERRED to the end of the
        apply: staging runs speculative admission, which must not move
        residency under an outstanding slot ticket."""
        ids_arr = np.unique(
            np.ascontiguousarray(np.asarray(ids).reshape(-1), np.int64))
        if self._ticket_open:
            self._deferred_prefetch = ids_arr
            return 0
        return self.store.dispatch_prefetch(ids_arr)
