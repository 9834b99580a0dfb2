"""The ingest prefetch stage, from ``lightctr_tpu/data/ingest.py``.

Only :func:`prefetch_batches` is here: the trainers' ``fit(prefetch=)`` and
``fit_stream(prefetch=)`` run it.  The JAX module's compiled shard cache
(``compile_shards``, ``ShardCache``, ``iter_shard_batches``, ``as_arrays``)
is not ported yet (ROADMAP.md §A.6).
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Iterable, Iterator

from lightctr_tpu_torch import obs
from lightctr_tpu_torch.obs import resources as resources_mod


def prefetch_batches(
    inner: Iterable,
    depth: int = 2,
    prepare=None,
    registry=None,
    monitor=None,
    name: str = "ingest_prefetch",
) -> Iterator:
    """Keep ``depth`` batches in flight behind the consumer: a worker
    thread drains ``inner``, runs ``prepare`` on each item (the trainer's
    staging of a batch onto its device: parse, pad and copy all happen OFF
    the step's critical path), and parks results in a bounded queue.

    The queue carries an :class:`~lightctr_tpu_torch.obs.resources.
    InstrumentedQueue` face (``resource_queue_*{queue=name}`` +
    ``queue_saturation`` when a monitor rides along), and the stage reports
    its own honesty gauge: ``ingest_overlap_ratio`` = fraction of consumer
    gets served without blocking.  A fully-hidden ingest reads ~1.0 (only
    the warm-up get blocks); a pipeline that secretly serializes reads
    ~0.0.

    Worker exceptions surface in the consumer (re-raised from the queue);
    closing the generator stops the worker and releases the queue
    telemetry."""
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    reg = registry if registry is not None else obs.default_registry()
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    iq = resources_mod.InstrumentedQueue(
        name, capacity=depth, registry=reg, monitor=monitor)
    stop_evt = threading.Event()

    def _put(kind, item) -> bool:
        """Park one queue entry, retrying until the consumer stops."""
        while not stop_evt.is_set():
            try:
                q.put((kind, item), timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def _worker():
        try:
            for item in inner:
                out = prepare(item) if prepare is not None else item
                if not _put(0, out):
                    return
                iq.note_enqueue()
                iq.set_depth(q.qsize())
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            _put(2, e)
        else:
            _put(1, None)

    t = threading.Thread(target=_worker, name=f"{name}-worker",
                         daemon=True)
    t.start()
    delivered = 0
    ready = 0
    try:
        while True:
            t0 = time.perf_counter()
            try:
                kind, item = q.get_nowait()
                waited = 0.0
                was_ready = True
            except queue_mod.Empty:
                was_ready = False
                kind, item = q.get()
                waited = time.perf_counter() - t0
            iq.set_depth(q.qsize())
            if kind == 1:
                return
            if kind == 2:
                raise item
            delivered += 1
            ready += was_ready
            iq.note_wait(waited)
            if obs.enabled():
                reg.inc("ingest_prefetch_batches_total")
                if was_ready:
                    reg.inc("ingest_prefetch_ready_total")
                reg.observe("ingest_wait_seconds", waited)
                reg.gauge_set("ingest_overlap_ratio", ready / delivered)
            yield item
    finally:
        stop_evt.set()
        while True:  # unblock a worker stuck on a full queue
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        t.join(timeout=5.0)
        iq.close()
