"""Stress of the launcher's rendezvous: many small gloo worlds spawned at
once while other sockets on the host take ports.

Each root named on the command line is a checkout of the repo (the tree
under test, or a parent unpacked with ``git archive``).  For each, in a
process of its own, ``PROCS`` processes each spawn ``WORLDS`` worlds of
two gloo ranks through that checkout's
``lightctr_tpu_torch.core.mesh.spawn_world`` (one all-reduce a world),
while ``CHURNERS`` threads bind sockets to port 0 of 127.0.0.1, listen,
and hold the last ``HOLD`` of them, as the servers of a test suite
running beside the worlds do.  A rendezvous that looks up a free port and
binds it again later loses it to them now and then; one that holds its
port from the start does not.  One JSON line a root: worlds that
succeeded, worlds that failed, the slowest world's seconds and the first
failures' last lines.  With no root, the package this process imports
is stressed.

    python -m lightctr_tpu_torch.tools.world_stress [ROOT ...]
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import threading
import time
import traceback


#: one world's deadline (its rendezvous and all-reduce time out at 30 s)
WORLD_DEADLINE_S = 120.0
#: processes spawning worlds at once, and worlds each spawns in turn
PROCS, WORLDS = 4, 10
#: threads binding port-0 sockets, and sockets each holds open
CHURNERS, HOLD = 2, 4000


def all_reduce_rank(rank, world):
    """A world's work: one all-reduce, checked."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4)
    dist.all_reduce(t)
    if float(t[0]) != world:
        raise AssertionError(f"rank {rank}: all_reduce gave {float(t[0])}")


def _churn(stop):
    socks = []
    while not stop.is_set():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(1)
        socks.append(s)
        if len(socks) > HOLD:
            socks.pop(0).close()
    for s in socks:
        s.close()


def _spawner(out):
    from lightctr_tpu_torch.core.mesh import spawn_world

    for _ in range(WORLDS):
        t0 = time.monotonic()
        try:
            spawn_world(all_reduce_rank, 2, "gloo",
                        deadline_s=WORLD_DEADLINE_S, timeout_s=30.0)
            out.put((True, time.monotonic() - t0, ""))
        except Exception as e:  # a failed world is the measurement
            msg = "".join(traceback.format_exception_only(type(e), e))
            out.put((False, time.monotonic() - t0,
                     msg.strip().splitlines()[-1][-300:]))


def stress() -> dict:
    """Spawn ``PROCS`` x ``WORLDS`` two-rank worlds from this checkout
    under ``CHURNERS`` port-0 binders; the counts."""
    stop = threading.Event()
    threads = [threading.Thread(target=_churn, args=(stop,), daemon=True)
               for _ in range(CHURNERS)]
    for t in threads:
        t.start()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    ps = [ctx.Process(target=_spawner, args=(out,)) for _ in range(PROCS)]
    for p in ps:
        p.start()
    # a world ends within its deadline, so a spawner that goes quiet for
    # longer has died
    res = [out.get(timeout=WORLD_DEADLINE_S + 60.0)
           for _ in range(PROCS * WORLDS)]
    for p in ps:
        p.join()
    stop.set()
    for t in threads:
        t.join()
    failed = [r for r in res if not r[0]]
    return {"ok": len(res) - len(failed), "failed": len(failed),
            "max_world_s": max(r[1] for r in res),
            "failures": [r[2] for r in failed[:3]]}


def main(argv=None) -> int:
    roots = sys.argv[1:] if argv is None else argv
    if not roots:
        print(json.dumps(stress()), flush=True)
        return 0
    # this file runs in each root as the top-level module world_stress
    # (a parent checkout may not have it), beside that root's package
    here = os.path.dirname(os.path.abspath(__file__))
    for root in roots:
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, "-c", "import sys, world_stress; "
             "sys.exit(world_stress.main([]))"],
            cwd=root, check=True, stdout=subprocess.PIPE, text=True,
            env={**os.environ,
                 "PYTHONPATH": os.pathsep.join([root, here])}).stdout
        rec = json.loads(out.strip().splitlines()[-1])
        print(json.dumps({"root": root, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
