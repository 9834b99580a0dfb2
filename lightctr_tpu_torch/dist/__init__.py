"""The distributed plane: the collectives and their cost model, the PS
wire and socket service (copied from ``lightctr_tpu/dist``: partition,
elastic checksums, wire codecs, ``ps_server``, heartbeat), the
hierarchical exchange's reduce shards (``hier``) and the master
(``master``).  The wire is byte-identical, so port and JAX peers talk to
each other."""

from lightctr_tpu_torch.dist.collectives import (
    dense_ring_bytes,
    ef_residual_init,
    expected_union,
    hier_exchange_bytes,
    hier_wire_bytes,
    link_bandwidth,
    LinkBandwidth,
    measure_ici_bw,
    pick_exchange_algo,
    prefer_sparse_exchange,
    ring_all_reduce,
    psum_all_reduce,
    rs_default_caps,
    rs_fits,
    sparse_all_reduce,
    sparse_ef_residual_init,
    sparse_exchange_bytes,
    sparse_reduce_scatter,
    sparse_rs_bytes,
)
from lightctr_tpu_torch.dist.bootstrap import (
    HeartbeatMonitor,
    initialize_multihost,
)

__all__ = [
    "dense_ring_bytes",
    "ef_residual_init",
    "expected_union",
    "hier_exchange_bytes",
    "hier_wire_bytes",
    "link_bandwidth",
    "LinkBandwidth",
    "measure_ici_bw",
    "pick_exchange_algo",
    "prefer_sparse_exchange",
    "ring_all_reduce",
    "psum_all_reduce",
    "rs_default_caps",
    "rs_fits",
    "sparse_all_reduce",
    "sparse_ef_residual_init",
    "sparse_exchange_bytes",
    "sparse_reduce_scatter",
    "sparse_rs_bytes",
    "HeartbeatMonitor",
    "initialize_multihost",
]
