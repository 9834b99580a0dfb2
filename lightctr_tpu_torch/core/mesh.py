"""Device meshes over ``torch.distributed``: the ``data``, ``model``,
``embed`` and ``seq`` axes.

The port's counterpart of ``lightctr_tpu/core/mesh.py``.  A JAX mesh lives
in one process and names its devices; a PyTorch mesh is one process per
rank.  A one-axis :class:`Mesh` wraps an initialised ``torch.distributed``
process group that is ONE axis of the JAX mesh, plus this rank's device:

  ``data``   every rank builds the same trainer, is handed the same global
             batch, and takes its own contiguous rows (:func:`shard_batch`,
             the ``P("data")`` layout);
  ``embed``  shards of a row-sharded table (``embed.table``'s sharded
             tables, :func:`embed_sharding`: rows ``[s*F/S, (s+1)*F/S)``
             on embed index ``s``);
  ``model``  tensor parallelism; it gets its group and nothing shards
             over it (no JAX function does either);
  ``seq``    the ring that ``nn.ring_attention.ring_self_attention`` walks:
             rank r holds sequence block r (the ``P(None, "seq")`` layout).

``MeshSpec(data=n)`` or ``MeshSpec(seq=n)`` gives that one-axis mesh.  A
spec with ``model`` or ``embed`` above 1, or ``data`` and ``seq`` both
above 1, gives a mesh of several axes: the ranks placed row-major over
:data:`AXES` as the JAX mesh reshapes its devices (rank = ((d*M + m)*E +
e)*S + s), one process group per line of each axis above 1, and a
one-axis view per axis (:meth:`Mesh.view`), which is the one-axis mesh
every collective takes.  :meth:`Mesh.require_axis` hands a function the
view of the axis it needs, or raises on a one-axis mesh over another.

:func:`data_sharding`, :func:`embed_sharding` and :func:`replicated` give
a :class:`Placement`, the port's stand-in for ``NamedSharding``: a mesh
and a partition spec.  The trainers' ``param_shardings`` is a tree of
them.

:func:`spawn_world` starts such a world on one host: one process per rank
(``torch.multiprocessing`` spawn), each with its process group initialised
through a rendezvous store that the caller's process hosts on 127.0.0.1,
joined with a deadline.  It lives in the package because spawn re-imports
the target's module in every child: a target defined next to JAX imports
would import JAX there too.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from lightctr_tpu_torch.core.device import resolve_device

#: seconds a rank waits at ``init_process_group`` and in any collective
#: before it fails (the spawned world's own deadline is separate)
DEFAULT_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape.  Axes default to 1 (absent)."""

    data: int = 1
    model: int = 1
    embed: int = 1
    seq: int = 1

    @property
    def size(self) -> int:
        return self.data * self.model * self.embed * self.seq

    def shape(self) -> tuple:
        return (self.data, self.model, self.embed, self.seq)


AXES = ("data", "model", "embed", "seq")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh.  A one-axis mesh: the process group
    whose ranks are the ``axis``, this rank's index on it, and the device
    its tensors live on.  A mesh of several axes (``spec`` set): the group
    of all its ranks, this rank's index there, and ``views``, the
    one-axis mesh of each axis in :data:`AXES` (an axis of size 1 is this
    rank alone, with no group)."""

    group: object
    rank: int
    device: torch.device
    axis: str = "data"
    spec: Optional["MeshSpec"] = None
    views: Optional[dict] = dataclasses.field(default=None, compare=False,
                                              repr=False)

    @property
    def size(self) -> int:
        """The axis' size: the group's number of ranks (1 for a view of
        one rank)."""
        if self.group is None:
            return 1
        return dist.get_world_size(self.group)

    def view(self, axis: str) -> "Mesh":
        """The one-axis mesh of ``axis``: of a mesh of several axes, its
        view; of a one-axis mesh, itself for its own axis and this rank
        alone for any other (JAX keeps axes of size 1 in every mesh)."""
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; axes are {AXES}")
        if self.views is not None:
            return self.views[axis]
        if axis == self.axis:
            return self
        return Mesh(group=None, rank=0, device=self.device, axis=axis)

    def require_axis(self, axis: str, owner: str) -> "Mesh":
        """The one-axis mesh ``owner`` runs on: the ``axis`` view of a
        mesh of several axes, or a one-axis mesh over ``axis`` itself;
        ``ValueError`` for a one-axis mesh over another axis."""
        if self.views is not None:
            return self.view(axis)
        if self.axis != axis:
            raise ValueError(f"{owner} needs a mesh over the {axis!r} axis, "
                             f"got one over {self.axis!r}")
        return self

    def coords(self) -> dict:
        """This rank's index on each axis ({axis: index})."""
        if self.views is not None:
            return {a: v.rank for a, v in self.views.items()}
        return {a: (self.rank if a == self.axis else 0) for a in AXES}

    @property
    def backend(self) -> str:
        """The group's backend: ``"nccl"`` takes CUDA tensors as they are,
        ``"gloo"`` has the collectives stage them through host memory."""
        return dist.get_backend(self.group)

    def global_rank(self, r: int) -> int:
        """The world rank of this group's rank ``r``."""
        if self.group is None:
            return dist.get_rank()
        return dist.get_global_rank(self.group, r)


def _one_axis(spec: MeshSpec) -> Optional[str]:
    """The axis of a one-axis spec (``data`` for a spec of one rank), or
    None for a spec that needs a mesh of several axes."""
    if spec.model > 1 or spec.embed > 1 or (spec.data > 1 and spec.seq > 1):
        return None
    return "seq" if spec.seq > 1 else "data"


def _axis_groups(spec: MeshSpec, group, me: int) -> dict:
    """{axis: (this rank's group on it, its index there)} for every axis
    above 1.  Every rank makes every line's group, the same groups in the
    same order (axes in :data:`AXES` order, lines row-major over the other
    axes), as ``dist.new_group`` requires of gloo."""
    shape = spec.shape()
    out = {}
    for ai, axis in enumerate(AXES):
        if shape[ai] == 1:
            continue
        others = [range(n) if i != ai else range(1)
                  for i, n in enumerate(shape)]
        for line in _product(others):
            members = []
            for k in range(shape[ai]):
                c = list(line)
                c[ai] = k
                members.append(_flat_rank(shape, c))
            ranks = [dist.get_global_rank(group, m) for m in members]
            g = dist.new_group(ranks)
            if me in members:
                out[axis] = (g, members.index(me))
    return out


def _product(ranges):
    if not ranges:
        yield ()
        return
    for head in ranges[0]:
        for tail in _product(ranges[1:]):
            yield (head,) + tail


def _flat_rank(shape, coords) -> int:
    """Row-major rank of mesh coordinates: ((d*M + m)*E + e)*S + s."""
    r = 0
    for n, c in zip(shape, coords):
        r = r * n + c
    return r


def make_mesh(spec: MeshSpec, device="cuda", group=None) -> Mesh:
    """The mesh of ``spec`` over an initialised process group (the default
    group unless ``group`` is given), whose size must be ``spec.size``.
    A one-axis spec gives the one-axis mesh over that group (the ``seq``
    axis when ``spec.seq > 1``, else ``data``); any other spec the mesh of
    several axes (module docstring), whose groups every rank of the group
    must make together.  ``device`` goes through
    :func:`~lightctr_tpu_torch.core.device.resolve_device`: CUDA by
    default, which raises on a host without CUDA (pass ``device="cpu"``);
    a CUDA device without an index is this rank's, ``cuda:<rank mod
    device count>``."""
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (see spawn_world)")
    group = group if group is not None else dist.group.WORLD
    axis = _one_axis(spec)
    world = dist.get_world_size(group)
    if world != spec.size:
        shape = (f"{axis}={spec.size}" if axis is not None else
                 " x ".join(f"{a}={n}" for a, n in zip(AXES, spec.shape())
                            if n > 1))
        raise ValueError(f"mesh spec {shape} but the process group has "
                         f"{world} ranks")
    rank = dist.get_rank(group)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if axis is not None:
        return Mesh(group=group, rank=rank, device=device, axis=axis)
    groups = _axis_groups(spec, group, rank)
    views = {}
    for a, n in zip(AXES, spec.shape()):
        if n == 1:
            views[a] = Mesh(group=None, rank=0, device=device, axis=a)
        else:
            g, r = groups[a]
            views[a] = Mesh(group=g, rank=r, device=device, axis=a)
    name = " x ".join(a for a, n in zip(AXES, spec.shape()) if n > 1)
    return Mesh(group=group, rank=rank, device=device, axis=name, spec=spec,
                views=views)


def local_mesh(n_data: Optional[int] = None, device="cuda") -> Mesh:
    """Data-parallel mesh over every rank of the default process group (or
    check that it has ``n_data``)."""
    n = n_data if n_data is not None else dist.get_world_size()
    return make_mesh(MeshSpec(data=n), device=device)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a leaf lives on a mesh: the port's ``NamedSharding``.  ``spec``
    is its partition spec, one entry a leading dimension (an axis name or
    None); ``()`` is replicated."""

    mesh: Mesh
    spec: tuple = ()

    @property
    def row_axis(self) -> Optional[str]:
        """The axis the leaf's rows are split over, or None."""
        return self.spec[0] if self.spec else None


def data_sharding(mesh: Mesh) -> Placement:
    """Batch-dim sharding over the ``data`` axis (leading dimension)."""
    return Placement(mesh, ("data",))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def embed_sharding(mesh: Mesh) -> Placement:
    """Row-sharding for embedding tables over the ``embed`` axis.

    Replaces the reference's consistent-hash key routing
    (consistent_hash.h:30-40) with contiguous block sharding: rows
    [s*F/S, (s+1)*F/S) live on shard s, and F must divide by S (the JAX
    ``device_put`` refuses any other table).  Load balancing of hot low
    ids is the loader's job (hash/fold ids, ``data.sparse``), not a row
    permutation."""
    return Placement(mesh, ("embed",))


def shard_batch(mesh: Mesh, batch, non_blocking: bool = False) -> dict:
    """This rank's rows of a host batch, on its device: rows
    ``[r*B/W, (r+1)*B/W)`` of every field, ``r`` this rank's index on the
    ``data`` axis and ``W`` its size (``P("data")``: every member of a
    line of the other axes takes the same rows).  Each field's leading
    size must divide by W.  ``non_blocking`` copies from pinned host
    memory asynchronously (the prefetch stage's staging)."""
    mesh = mesh.require_axis("data", "shard_batch")
    w, r = mesh.size, mesh.rank
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        n = t.shape[0]
        if n % w:
            raise ValueError(f"batch field {k!r} has {n} rows, not a multiple "
                             f"of the {w}-rank data axis")
        out[k] = t[r * (n // w):(r + 1) * (n // w)].to(
            mesh.device, non_blocking=non_blocking)
    return out


# -- the launcher ------------------------------------------------------------


def _rank_main(rank, fn, world, backend, port, timeout_s, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, world_size=world,
                          is_master=False, timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank, timeout=timeout)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn: Callable, world: int, backend: str = "gloo",
                args: tuple = (), deadline_s: float = 300.0,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    with its default process group initialised (``backend``, ``timeout_s``
    for the rendezvous and every collective).

    The rendezvous store is this process's: a ``TCPStore`` bound to a port
    of 127.0.0.1 that the OS picks, held from before the ranks start until
    the world ends, which the ranks join as clients.  No other process can
    take its port in between, as one could when a free port was looked up,
    closed and bound again by rank 0 seconds later.

    ``fn`` must be importable from its module (spawn re-imports it in each
    child).  A rank that raises makes this raise (the others are stopped);
    a world still running after ``deadline_s`` seconds is killed and
    ``TimeoutError`` raised.  The caller chooses each rank's device inside
    ``fn`` (``make_mesh``'s default: ``cuda:<rank mod devices>``)."""
    import torch.multiprocessing as mp

    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, store.port, timeout_s, args),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > end:
                raise TimeoutError(f"spawned world of {world} ranks still "
                                   f"running after {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(timeout=5)
