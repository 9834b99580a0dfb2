"""Elastic-membership vocabulary: epoch-numbered routing tables, the
deterministic worker->data-shard map, and the migration frame checksum.

The reference survives node churn by re-consulting its ``ConsistentHash``
ring on every key and letting the master's heartbeat ledger drive
re-registration (consistent_hash.h:18-67, master.h:202-262) — but it never
MOVES rows; a key whose shard died is simply re-created from scratch on its
new owner.  This module is the state the repo's act-on-failure loop shares
between master, PS shards, and workers so rows migrate instead:

  - :class:`RoutingTable` — one immutable epoch of cluster membership
    (live shard ids + their addresses + the partition policy + the live
    worker set + an in-flight-rebalance flag).  The master publishes it
    over ``MSG_ROUTE``; ``ShardedPSClient`` swaps to a newer epoch
    atomically between (never inside) batches.
  - :func:`assign_data_shards` — worker join/leave keyed off the
    membership epoch: every process computes the same worker->data-shard
    map from (epoch, live worker ids) with no extra coordination, the way
    every reference worker derives its file stripe from its node id.
  - :func:`frame_checksum` — lane-parallel FNV-1a64 over a migration
    frame's bytes.  Source and destination hash the same
    ``wire.pack_rows`` bytes (the destination AFTER re-reading the rows
    from its store), so a matching checksum certifies the rows LANDED,
    not merely arrived.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence, Tuple

import numpy as np

from lightctr_tpu_torch.dist.partition import (
    _FNV_OFFSET,
    _FNV_PRIME,
    fnv1a64_keys,
    make_partition,
)

ROUTE_SCHEMA_VERSION = 1


def frame_checksum(buf: bytes) -> int:
    """Vectorized FNV-1a64 checksum of a byte frame.

    Classic FNV is byte-serial (useless on multi-MB row payloads from
    Python); this is the lane-parallel construction the key hasher already
    uses: the frame is padded to 8-byte lanes, each lane FNV-hashed
    (partition.fnv1a64_keys), the lane hashes XOR-folded, and the true
    byte length mixed in with one more FNV round so frames differing only
    in padding cannot collide.  Deterministic across processes and
    architectures (little-endian lane view)."""
    n = len(buf)
    if n % 8:
        buf = buf + b"\x00" * (8 - n % 8)
    lanes = np.frombuffer(buf, "<i8")
    if len(lanes):
        folded = np.uint64(np.bitwise_xor.reduce(fnv1a64_keys(lanes)))
    else:
        folded = _FNV_OFFSET
    # one scalar FNV round over the fold + length: masks padding ambiguity
    # (python-int arithmetic — numpy uint64 scalar multiply warns on the
    # intended wraparound)
    h = int(folded)
    for b in int(n).to_bytes(8, "little"):
        h = ((h ^ b) * int(_FNV_PRIME)) & 0xFFFFFFFFFFFFFFFF
    return h


def assign_data_shards(
    worker_ids: Sequence[int], n_data_shards: int, epoch: int
) -> Dict[int, int]:
    """Deterministic data-shard -> worker assignment for a membership
    epoch: every process holding the same (epoch, live worker set) computes
    the same map, so a readmitted or fresh worker resumes from the epoch's
    shard map with no negotiation.  The epoch rotates the deal so
    reassignment after churn is visible (and testable) rather than
    accidentally identical."""
    ws = sorted(int(w) for w in set(worker_ids))
    if not ws:
        raise ValueError("assign_data_shards needs at least one worker")
    return {
        s: ws[(s + int(epoch)) % len(ws)] for s in range(int(n_data_shards))
    }


def shards_of_worker(
    worker_id: int, worker_ids: Sequence[int], n_data_shards: int, epoch: int
) -> List[int]:
    """The inverse view a worker's input loop wants: which data shards are
    mine this epoch?"""
    a = assign_data_shards(worker_ids, n_data_shards, epoch)
    return sorted(s for s, w in a.items() if w == int(worker_id))


class RoutingTable:
    """One epoch of cluster membership, immutable once published.

    ``members`` are live shard ids; ``addresses[shard_id]`` is where each
    one serves (the address list covers every shard id ever admitted, so
    ids stay stable across departures).  ``partition()`` builds the
    key->shard policy over exactly the live members.  ``rebalancing``
    marks an in-flight row migration: clients keep retrying rather than
    treating misses as loss, and the SSP staleness budget runs widened
    until the flag drops."""

    def __init__(
        self,
        epoch: int,
        members: Sequence[int],
        addresses: Dict[int, Tuple[str, int]],
        partition: str = "ring",
        workers: Sequence[int] = (),
        rebalancing: bool = False,
        vnodes: int = 5,
    ):
        self.epoch = int(epoch)
        self.members = sorted(int(m) for m in set(members))
        if not self.members:
            raise ValueError("routing table needs at least one live shard")
        self.addresses = {
            int(s): (str(a[0]), int(a[1])) for s, a in addresses.items()
        }
        missing = [s for s in self.members if s not in self.addresses]
        if missing:
            raise ValueError(f"members without addresses: {missing}")
        self.partition_name = str(partition)
        self.workers = sorted(int(w) for w in set(workers))
        self.rebalancing = bool(rebalancing)
        self.vnodes = int(vnodes)

    def partition(self):
        return make_partition(
            self.partition_name, members=self.members, vnodes=self.vnodes
        )

    # -- serialization (the MSG_ROUTE payload) -----------------------------

    def to_dict(self) -> Dict:
        return {
            "v": ROUTE_SCHEMA_VERSION,
            "epoch": self.epoch,
            "members": list(self.members),
            "addresses": {
                str(s): list(a) for s, a in sorted(self.addresses.items())
            },
            "partition": self.partition_name,
            "workers": list(self.workers),
            "rebalancing": self.rebalancing,
            "vnodes": self.vnodes,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "RoutingTable":
        return cls(
            epoch=d["epoch"],
            members=d["members"],
            addresses={int(s): tuple(a) for s, a in d["addresses"].items()},
            partition=d.get("partition", "ring"),
            workers=d.get("workers", ()),
            rebalancing=d.get("rebalancing", False),
            vnodes=d.get("vnodes", 5),
        )

    @classmethod
    def from_json(cls, s: str) -> "RoutingTable":
        return cls.from_dict(json.loads(s))

    # -- membership transitions (pure: each returns a NEW table) ------------

    def without_shard(self, shard_id: int, rebalancing: bool = True
                      ) -> "RoutingTable":
        members = [m for m in self.members if m != int(shard_id)]
        return RoutingTable(
            self.epoch + 1, members, self.addresses, self.partition_name,
            self.workers, rebalancing, self.vnodes,
        )

    def with_shard(self, shard_id: int, address: Tuple[str, int],
                   rebalancing: bool = True) -> "RoutingTable":
        addresses = dict(self.addresses)
        addresses[int(shard_id)] = tuple(address)
        members = sorted(set(self.members) | {int(shard_id)})
        return RoutingTable(
            self.epoch + 1, members, addresses, self.partition_name,
            self.workers, rebalancing, self.vnodes,
        )

    def settled(self) -> "RoutingTable":
        """The same membership with the rebalancing flag dropped — same
        epoch: the flag is advisory (grace window), not a routing change,
        and bumping would force every client through a pointless
        re-split."""
        t = RoutingTable(
            self.epoch, self.members, self.addresses, self.partition_name,
            self.workers, False, self.vnodes,
        )
        return t


def plan_migration(
    keys: np.ndarray, table: "RoutingTable"
) -> Dict[int, np.ndarray]:
    """Split a sorted key batch by the table's partition -> {shard_id:
    keys} for every non-empty destination — the master's migration plan,
    and (property-tested) exactly the split every client derives from the
    same table."""
    keys = np.ascontiguousarray(keys, np.int64)
    if not len(keys):
        return {}
    part = table.partition()
    shard = part.shard_of(keys)
    out: Dict[int, np.ndarray] = {}
    for s in table.members:
        idx = np.flatnonzero(shard == s)
        if idx.size:
            out[s] = keys[idx]
    return out
