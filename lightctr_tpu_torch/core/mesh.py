"""Device meshes over ``torch.distributed``: the ``data`` and ``seq`` axes.

The port's counterpart of ``lightctr_tpu/core/mesh.py``.  A JAX mesh lives
in one process and names its devices; a PyTorch mesh is one process per
rank.  Here a :class:`Mesh` wraps an initialised ``torch.distributed``
process group that is ONE axis of the JAX mesh, plus this rank's device:

  ``data``  every rank builds the same trainer, is handed the same global
            batch, and takes its own contiguous rows (:func:`shard_batch`,
            the ``P("data")`` layout);
  ``seq``   the ring that ``nn.ring_attention.ring_self_attention`` walks:
            rank r holds sequence block r (the ``P(None, "seq")`` layout).

A mesh's group is one axis only: ``MeshSpec(data=n)`` or ``MeshSpec(seq=n)``.
A function that needs the other axis raises (:meth:`Mesh.require_axis`).
The ``model`` and ``embed`` axes, and meshes with two axes above 1, are not
ported yet.

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a one-axis mesh: the process group whose ranks
    are the ``axis`` (``"data"`` or ``"seq"``), this rank's index on it,
    and the device its tensors live on."""

    group: object
    rank: int
    device: torch.device
    axis: str = "data"

    @property
    def size(self) -> int:
        """The axis' size: the group's number of ranks."""
        return dist.get_world_size(self.group)

    def require_axis(self, axis: str, owner: str) -> None:
        """Raise ``ValueError`` unless this mesh's group is ``axis``."""
        if self.axis != axis:
            raise ValueError(f"{owner} needs a mesh over the {axis!r} axis, "
                             f"got one over {self.axis!r}")

    @property
    def backend(self) -> str:
        """The group's backend: ``"nccl"`` takes CUDA tensors as they are,
        ``"gloo"`` has the collectives stage them through host memory."""
        return dist.get_backend(self.group)

    def global_rank(self, r: int) -> int:
        """The world rank of this group's rank ``r``."""
        return dist.get_global_rank(self.group, r)


def make_mesh(spec: MeshSpec, device="cuda", group=None) -> Mesh:
    """The mesh of ``spec`` over an initialised process group (the default
    group unless ``group`` is given), whose size must be ``spec.size``.
    The group is the ``seq`` axis when ``spec.seq > 1``, else the ``data``
    axis; a spec with both above 1 is refused.  ``device`` goes through
    :func:`~lightctr_tpu_torch.core.device.resolve_device`: CUDA by
    default, which raises on a host without CUDA (pass ``device="cpu"``);
    a CUDA device without an index is this rank's, ``cuda:<rank mod
    device count>``."""
    from lightctr_tpu_torch.models.ctr_trainer import not_yet_ported

    not_yet_ported("make_mesh", model=spec.model > 1, embed=spec.embed > 1,
                   data_and_seq=spec.data > 1 and spec.seq > 1)
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (see spawn_world)")
    group = group if group is not None else dist.group.WORLD
    axis = "seq" if spec.seq > 1 else "data"
    world = dist.get_world_size(group)
    if world != spec.size:
        raise ValueError(f"mesh spec {axis}={spec.size} but the process "
                         f"group has {world} ranks")
    rank = dist.get_rank(group)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(group=group, rank=rank, device=device, axis=axis)


def local_mesh(n_data: Optional[int] = None, device="cuda") -> Mesh:
    """Data-parallel mesh over every rank of the default process group (or
    check that it has ``n_data``)."""
    n = n_data if n_data is not None else dist.get_world_size()
    return make_mesh(MeshSpec(data=n), device=device)


def shard_batch(mesh: Mesh, batch, non_blocking: bool = False) -> dict:
    """This rank's rows of a host batch, on its device: rows
    ``[r*B/W, (r+1)*B/W)`` of every field (``P("data")``).  Each field's
    leading size must divide by the world.  ``non_blocking`` copies from
    pinned host memory asynchronously (the prefetch stage's staging)."""
    mesh.require_axis("data", "shard_batch")
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
