"""Hand-written CUDA kernels for the sparse hot path — registry, build,
launch counts and dispatch.

The port's counterpart of ``lightctr_tpu/ops/sparse_kernels.py``.  Every
kernel the JAX package wrote in Pallas for the TPU becomes a kernel written
by hand for Hopper (``csrc/*.cu``, built for ``sm_90a`` with ``nvcc`` into a
shared library with a plain C interface and loaded with ``ctypes``), and
each ships beside it a **plain PyTorch version** of the same function.

Dispatch follows the tensor's device, nothing else:

  - a CPU tensor runs the plain version;
  - a CUDA tensor launches the kernel, or raises (wrong dtype, shape or
    layout; a build that fails; a launch the driver refuses).

There is no environment switch and no fallback from the kernel to the plain
version.  Each CUDA wrapper adds one to its kernel's launch count where it
launches, and nowhere else, so a run can show that its main path went
through the kernel (:func:`launches` / :func:`reset_launches`).

Kernels are built at first use (or eagerly through :func:`load` /
:func:`build_all`) into ``lightctr_tpu_torch/build/``, keyed by a digest
of the source and the compiler flags.  Importing this module builds
nothing.  Each library loaded is reported to the build listeners
(:func:`add_build_listener`: the resources plane's compile tracker) with
the seconds of its nvcc build and its ``ctypes`` load.

While a cost recorder is set (:func:`record_costs`: the device plane's
program catalog, for one call), every dispatched kernel call reports the
bytes it must move and the operations it does, counted from its inputs
as ``chip_smoke.py``'s bounds count them (:func:`kernel_cost`), and marks
its extent (:func:`in_kernel`) so that the library ops a plain version
runs are not counted twice.

Every TPU kernel of the JAX package has its counterpart: ``gather_rows``
(``_gather_pallas``), ``dedup_ids`` (``_dedup_pallas``, int32 and int64
ids), ``merge_rows`` (``_merge_pallas``), ``merge_apply`` in both modes
(``_merge_apply_pallas``), ``quantize_pack`` (``_qp_pallas``),
``quantize_pack_ef`` (``_qp_ef_pallas``), ``quantize_pack_ef_update``
(``_qp_ef_update_pallas``) and, registered from their own modules,
``fused_adagrad`` (``optim/fused_adagrad.py``, ``_adagrad_pallas``) and
``flash_attention`` (``nn/flash_attention.py``, ``_flash_pallas``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, NamedTuple, Optional

import torch

from lightctr_tpu_torch.embed.table import (
    SparseAdagradState,
    sparse_adagrad_update,
)
from lightctr_tpu_torch.ops import quantize
from lightctr_tpu_torch.utils import profiling

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

#: nvcc flags for every kernel: Hopper's sm_90a target, a plain C shared
#: library; ``-Xptxas -v`` puts registers and spills in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the dispatch phases a kernel may declare (as in the JAX package)
KERNEL_PHASES = ("dedup", "merge", "apply", "pack", "gather", "adagrad",
                 "attention")


class KernelDef(NamedTuple):
    name: str
    phase: str                            # one of KERNEL_PHASES
    plain: Callable                       # plain PyTorch version (CPU tensors)
    cuda: Callable                        # wrapper launching the CUDA kernel
    source: str                           # file under csrc/
    bind: Callable[[ctypes.CDLL], None]   # sets the C entries' signatures
    replaces: str                         # the TPU kernel, file:line


#: name -> KernelDef: every ported kernel
KERNELS: Dict[str, KernelDef] = {}

_launches: Dict[str, int] = {}
#: name -> {variant: launches}, for a kernel whose wrapper picks among
#: designs (flash_attention's route, merge_apply's mode)
_variant_launches: Dict[str, Dict[str, int]] = {}
_launch_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
#: source file -> nvcc's output of its last build in this process
BUILD_LOGS: Dict[str, str] = {}
#: library path -> seconds of its nvcc build, until its load reports them
_pending_build_s: Dict[str, float] = {}
_build_listeners: list = []
#: name -> (same arguments as the kernel) -> (bytes, operations)
KERNEL_COSTS: Dict[str, Callable] = {}
#: the cost recorder, ``fn(name, nbytes, flops)``, while one is set
_cost_sink: Optional[Callable] = None
_cost_lock = threading.Lock()
_scope = threading.local()


def register_kernel(name: str, *, phase: str, plain: Callable,
                    cuda: Callable, source: str,
                    bind: Callable[[ctypes.CDLL], None],
                    replaces: str, cost: Optional[Callable] = None) -> None:
    """Register a hand-written kernel with its plain PyTorch version and,
    with ``cost``, the function that counts a call's bytes and operations
    from its arguments (:func:`kernel_cost`)."""
    if phase not in KERNEL_PHASES:
        raise ValueError(f"unknown kernel phase {phase!r}")
    KERNELS[name] = KernelDef(name, phase, plain, cuda, source, bind,
                              replaces)
    if cost is not None:
        KERNEL_COSTS[name] = cost
    with _launch_lock:
        _launches.setdefault(name, 0)


def add_build_listener(fn: Callable) -> None:
    """Call ``fn("kernel_build", seconds)`` for every kernel library this
    process loads (nvcc seconds, when it built here, plus the ``ctypes``
    load)."""
    if fn not in _build_listeners:
        _build_listeners.append(fn)


def remove_build_listener(fn: Callable) -> None:
    if fn in _build_listeners:
        _build_listeners.remove(fn)


def _notify_build(seconds: float) -> None:
    for fn in list(_build_listeners):
        try:
            fn("kernel_build", seconds)
        except Exception:
            pass  # a listener must never break a kernel load


# =========================================================================
# cost recording (the device plane's program analysis)
# =========================================================================


def kernel_cost(name: str, *args):
    """``(bytes, operations)`` of one call of kernel ``name`` on ``args``
    (the kernel's own arguments): each input read once and each output
    written once, as ``chip_smoke.py``'s bounds count them; where the
    work depends on the data (pad slots, distinct rows) it is counted from
    these inputs.  None for a kernel without a cost function."""
    fn = KERNEL_COSTS.get(name)
    return None if fn is None else fn(*args)


@contextlib.contextmanager
def record_costs(sink: Callable):
    """Set ``sink(name, nbytes, flops)`` as the cost recorder for the
    block: every kernel dispatched meanwhile (from any thread — autograd's
    backward runs on its own) reports its :func:`kernel_cost`.  One
    recorder at a time; a nested one raises."""
    global _cost_sink
    with _cost_lock:
        if _cost_sink is not None:
            raise RuntimeError("a kernel cost recorder is already set")
        _cost_sink = sink
    try:
        yield
    finally:
        with _cost_lock:
            _cost_sink = None


def in_kernel() -> bool:
    """Whether this thread is inside a dispatched kernel call while a cost
    recorder is set (the library ops of a plain version run there)."""
    return getattr(_scope, "depth", 0) > 0


def _recorded(name: str, fn: Callable, *args):
    _scope.depth = getattr(_scope, "depth", 0) + 1
    try:
        out = fn(*args)
    finally:
        _scope.depth -= 1
    sink = _cost_sink
    if sink is not None:
        cost = kernel_cost(name, *args)
        if cost is not None:
            sink(name, int(cost[0]), float(cost[1]))
    return out


def launches(name: Optional[str] = None):
    """Launch count of kernel ``name`` — or a dict of all counts."""
    with _launch_lock:
        return dict(_launches) if name is None else _launches[name]


def variant_launches(name: str) -> Dict[str, int]:
    """Launches of kernel ``name`` by the design that ran (empty for a
    kernel with one design)."""
    with _launch_lock:
        return dict(_variant_launches.get(name, {}))


def reset_launches() -> None:
    """Set every kernel's launch count, and its counts by design, to 0."""
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0
        _variant_launches.clear()


def _count_launch(name: str, variant: Optional[str] = None) -> None:
    with _launch_lock:
        _launches[name] += 1
        if variant is not None:
            by = _variant_launches.setdefault(name, {})
            by[variant] = by.get(variant, 0) + 1


def next_pow2(n: int, floor: int = 8) -> int:
    """THE pad policy for kernel-facing dynamic lengths: the next power
    of two >= ``n`` (min ``floor``), the same ladder as the JAX package,
    so serve (model/cache) pads batches and row blocks alike."""
    out = floor
    while out < n:
        out *= 2
    return out


# =========================================================================
# build and load
# =========================================================================


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build CUDA kernels")


def _so_path(source: str) -> str:
    """The library path of ``source``, keyed by a digest of the source, the
    shared headers it may include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def compile_source(source: str) -> str:
    """Build ``csrc/<source>`` into the build directory (once per source
    digest) and return the shared library's path; raises on a failed
    build with nvcc's output."""
    so_path = _so_path(source)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # per-process, per-thread temp path, then an atomic rename: two builds
    # racing here never load a half-written library
    tmp = f"{so_path}.tmp.{os.getpid()}.{threading.get_ident()}"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    os.replace(tmp, so_path)
    with _lib_lock:
        _pending_build_s[so_path] = (_pending_build_s.get(so_path, 0.0)
                                     + time.perf_counter() - t0)
    return so_path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lib_lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    kd = KERNELS[name]
    path = compile_source(kd.source)
    t0 = time.perf_counter()
    lib = ctypes.CDLL(path)
    kd.bind(lib)
    seconds = time.perf_counter() - t0
    with _lib_lock:
        seconds += _pending_build_s.pop(path, 0.0)
        lib = _libs.setdefault(name, lib)
    _notify_build(seconds)
    return lib


def build_all() -> Dict[str, str]:
    """Build and load every registered kernel, one nvcc per source, all
    started together; returns name -> library path."""
    names = sorted(KERNELS)
    if not names:
        return {}
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        futs = {n: ex.submit(compile_source, KERNELS[n].source)
                for n in names}
        paths = {n: f.result() for n, f in futs.items()}
    for n in names:
        load(n)
    return paths


def dispatch(name: str, device: torch.device) -> Callable:
    """Kernel ``name``'s implementation for ``device``: the plain version
    on the CPU, the CUDA wrapper on a CUDA device (reporting its cost
    while a recorder is set, :func:`record_costs`).  While spans are on
    (``utils.profiling.spans_on``) the call is the span ``kernel/<name>``:
    a kernel launched through ``ctypes`` leaves no host operation in a
    profiler trace of its own."""
    kd = KERNELS[name]
    if device.type == "cpu":
        fn = kd.plain
    elif device.type == "cuda":
        fn = kd.cuda
    else:
        raise ValueError(f"{name}: no implementation for device {device}")
    if _cost_sink is not None:
        fn = functools.partial(_recorded, name, fn)
    if profiling.spans_on():
        fn = functools.partial(_spanned, "kernel/" + name, fn)
    return fn


def _spanned(span: str, fn: Callable, *args, **kwargs):
    with profiling.annotate(span):
        return fn(*args, **kwargs)


def run_kernel(name: str, device: torch.device, entry, *args,
               variant: Optional[str] = None) -> None:
    """Call the C entry ``entry(*args, stream)`` on ``device``'s current
    stream (no synchronise); raise on a non-zero CUDA error, else count
    one launch of kernel ``name`` (and of its design ``variant``, where the
    wrapper picked one)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count_launch(name, variant)


def check_cuda_tensors(name: str, **tensors) -> torch.device:
    """The device all ``tensors`` share, which must be a CUDA device, and
    each must be contiguous; raises ``ValueError`` otherwise."""
    devs = {t.device for t in tensors.values()}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(f"{name} kernel needs {', '.join(tensors)} on one "
                         f"CUDA device, got {sorted(map(str, devs))}")
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs a contiguous {what}")
    return dev


def bind_entry(lib: ctypes.CDLL, sym: str, argtypes,
               restype=ctypes.c_int) -> None:
    """Set the ctypes signature of C entry ``sym``: pointers and the stream
    as ``c_void_p``, so none is cut to a 32-bit int."""
    fn = getattr(lib, sym)
    fn.restype = restype
    fn.argtypes = argtypes


# =========================================================================
# gather_rows: the device-resident row path's read half
# =========================================================================
#
# ``rows = block[clip(int32(idx))]`` — the serving cache's device-block
# hits (serve/cache.py).  Replaces lightctr_tpu/ops/sparse_kernels.py
# ``_gather_pallas`` / ``_gather_kernel``; csrc/gather_rows.cu has the
# kernel and its design note.


def gather_rows_plain(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: ``block[clip(int32(idx), 0, R - 1)]`` (the JAX
    package's ``jnp.take(mode="clip")`` after its int32 cast)."""
    sel = idx.reshape(-1).to(torch.int32).clamp(0, block.shape[0] - 1)
    return block.index_select(0, sel)


_P, _LL, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float


def _bind_gather_rows(lib: ctypes.CDLL) -> None:
    for sym in ("gather_rows_f32_i32", "gather_rows_f32_i64"):
        bind_entry(lib, sym, [_P, _P, _P, _LL, _LL, _LL, _P])
    bind_entry(lib, "gather_rows_floor", [_P, _P, _LL, _LL, _LL, _P])


def _gather_rows_cuda(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; no synchronise."""
    out = torch.empty((idx.numel(),) + tuple(block.shape[1:]),
                      dtype=block.dtype, device=block.device)
    if out.numel():
        _gather_rows_into(block, idx, out)
    else:
        _check_gather("gather_rows", block, idx, out)
    return out


def _check_gather(name: str, block: torch.Tensor, idx: torch.Tensor,
                  out: torch.Tensor) -> torch.device:
    """The device of a gather of ``idx``'s rows of ``block`` into ``out``:
    a float32 block, int32/int64 indices (``TypeError`` otherwise), and
    all three contiguous on one CUDA device with ``out`` of ``idx.numel()``
    rows of the block's width (``ValueError`` otherwise)."""
    if block.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes a float32 block and out, got "
                        f"{block.dtype} and {out.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} kernel takes int32/int64 indices, "
                        f"got {idx.dtype}")
    dev = check_cuda_tensors(name, block=block, idx=idx, out=out)
    if block.dim() < 1 or out.numel() != idx.numel() * _row_width(block):
        raise ValueError(f"{name}: out {tuple(out.shape)} for {idx.numel()} "
                         f"rows of block {tuple(block.shape)}")
    return dev


def _row_width(block: torch.Tensor) -> int:
    return math.prod(block.shape[1:])


def _gather_rows_into(block: torch.Tensor, idx: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch the gather kernel into ``out``, which may start anywhere a
    float may; at least one row of at least one float."""
    dev = _check_gather("gather_rows", block, idx, out)
    if not out.numel():
        raise ValueError("gather_rows: nothing to gather")
    fn = (load("gather_rows").gather_rows_f32_i32
          if idx.dtype == torch.int32
          else load("gather_rows").gather_rows_f32_i64)
    run_kernel("gather_rows", dev, fn, block.data_ptr(), idx.data_ptr(),
               out.data_ptr(), block.shape[0], _row_width(block), idx.numel())


def gather_rows_floor(block: torch.Tensor, idx: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch an empty kernel at the grid and block the gather of ``idx``
    (int32) into ``out`` would take: the launch's floor, which moves
    nothing and counts no launch."""
    dev = _check_gather("gather_rows_floor", block, idx, out)
    if idx.dtype != torch.int32 or not out.numel():
        raise ValueError("gather_rows_floor: int32 ids, at least one row")
    fn = load("gather_rows").gather_rows_floor
    with torch.cuda.device(dev):
        err = fn(block.data_ptr(), out.data_ptr(), block.shape[0],
                 _row_width(block), idx.numel(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows_floor launch failed: CUDA error "
                           f"{err}")


def _gather_rows_cost(block, idx):
    """The distinct rows read, the indices, the rows written."""
    n, d = idx.numel(), _row_width(block)
    read = int(torch.unique(idx.clamp(0, block.shape[0] - 1)).numel())
    return (read * d * block.element_size() + n * idx.element_size()
            + n * d * block.element_size()), 0.0

register_kernel(
    "gather_rows", phase="gather", plain=gather_rows_plain,
    cuda=_gather_rows_cuda, source="gather_rows.cu", bind=_bind_gather_rows,
    replaces="lightctr_tpu/ops/sparse_kernels.py:733",
    cost=_gather_rows_cost,
)


def gather_rows(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Dispatch: ``block[idx]`` row gather with out-of-range indices
    clipped.  The plain version on a CPU tensor, the CUDA kernel on a
    CUDA tensor."""
    idx = idx.reshape(-1)
    if idx.device != block.device:
        raise ValueError(f"gather_rows: block on {block.device}, "
                         f"idx on {idx.device}")
    if idx.numel() == 0:
        return block.new_zeros((0,) + tuple(block.shape[1:]))
    if block.shape[0] == 0:
        raise ValueError("gather_rows: cannot gather from an empty block")
    return dispatch("gather_rows", block.device)(block, idx)


# =========================================================================
# dedup_ids: unique + inverse over an id stream
# =========================================================================
#
# The exact ``jnp.unique(ids, return_inverse=True, size=size,
# fill_value=0)`` contract plus the distinct count — the sparse trainer's
# per-step dedup of each id stream.  Replaces lightctr_tpu/ops/
# sparse_kernels.py ``_dedup_pallas`` / ``_dedup_kernel``; csrc/dedup_ids.cu
# has the kernel (a radix sort and a scan, not the TPU's O(K^2) rank
# compare) and its design note.


def dedup_ids_plain(ids: torch.Tensor, size: int):
    """Plain version: sorted unique ids padded with 0 to ``size`` (cut at
    ``size`` when there are more), the inverse at full rank (int32, it may
    reach past ``size``), and the distinct count as a 0-d int32 tensor."""
    u, inv = torch.unique(ids, sorted=True, return_inverse=True)
    uids = ids.new_zeros((size,))
    n = min(size, u.shape[0])
    uids[:n] = u[:n]
    inv = inv.reshape(-1).to(torch.int32)
    return uids, inv, (inv.max() + 1).to(torch.int32)


def _bind_dedup_ids(lib: ctypes.CDLL) -> None:
    bind_entry(lib, "dedup_ids_workspace_bytes", [_LL, ctypes.c_int],
               restype=_LL)
    for sym in ("dedup_ids_i32", "dedup_ids_i64"):
        bind_entry(lib, sym, [_P, _LL, _LL, _P, _P, _P, _P, _P])


def _dedup_ids_cuda(ids: torch.Tensor, size: int):
    """Launch the CUDA dedup on the current stream; no synchronise.  The
    count stays on the card.  int32 and int64 ids; uids keep the ids'
    dtype."""
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"dedup_ids kernel takes int32 or int64 ids, got "
                        f"{ids.dtype}")
    dev = check_cuda_tensors("dedup_ids", ids=ids)
    k = ids.numel()
    wide = ids.dtype == torch.int64
    lib = load("dedup_ids")
    work = torch.empty((lib.dedup_ids_workspace_bytes(k, int(wide)),),
                       dtype=torch.uint8, device=dev)
    uids = torch.empty((size,), dtype=ids.dtype, device=dev)
    inv = torch.empty((k,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    run_kernel("dedup_ids", dev,
               lib.dedup_ids_i64 if wide else lib.dedup_ids_i32,
               ids.data_ptr(), k, size, uids.data_ptr(), inv.data_ptr(),
               count.data_ptr(), work.data_ptr())
    return uids, inv, count


def _dedup_ids_cost(ids, size):
    """The ids read, the int32 inverse and the uids written."""
    k = ids.numel()
    return k * ids.element_size() + k * 4 + size * ids.element_size(), 0.0


register_kernel(
    "dedup_ids", phase="dedup", plain=dedup_ids_plain, cuda=_dedup_ids_cuda,
    source="dedup_ids.cu", bind=_bind_dedup_ids,
    replaces="lightctr_tpu/ops/sparse_kernels.py:227",
    cost=_dedup_ids_cost,
)


def dedup_ids(ids: torch.Tensor, size: Optional[int] = None):
    """Dispatch: unique+inverse over one id stream -> ``(uids, inv,
    count)``.  ``size`` defaults to ``len(ids)`` (no truncation); with
    ``size < count`` the unique array is cut while ``inv`` keeps full
    ranks.  The plain version on a CPU tensor (any integer dtype), the CUDA
    kernel on a CUDA tensor (int32 or int64, exact at either width; it
    raises ``TypeError`` for other dtypes)."""
    ids = ids.reshape(-1)
    k = ids.shape[0]
    if size is None:
        size = k
    if k == 0:
        return (ids.new_zeros((size,)),
                torch.zeros((0,), dtype=torch.int32, device=ids.device),
                torch.zeros((), dtype=torch.int32, device=ids.device))
    return dispatch("dedup_ids", ids.device)(ids, size)


# =========================================================================
# merge_rows: duplicate-slot segment merge
# =========================================================================
#
# ``segment_sum(rows, inv, num_segments)`` with segments outside
# ``[0, num_segments)`` dropped, each segment's rows added in increasing
# slot order — the allgather exchange's merge of the gathered gradient
# rows.  Replaces lightctr_tpu/ops/sparse_kernels.py ``_merge_pallas`` /
# ``_merge_kernel``; csrc/merge_rows.cu has the kernel (a radix sort of
# (segment, slot) pairs, then walkers over the short and the long runs,
# from csrc/segment_runs.cuh) and its design note.


def merge_rows_plain(rows: torch.Tensor, inv: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Plain version: ``jax.ops.segment_sum`` bit for bit.  Each segment
    adds its rows in increasing slot order, from zero: on the CPU
    ``index_add_`` walks its indices in order; on the card it accumulates
    with atomics in no fixed order, so round r adds the r-th row of every
    segment (one row per segment a round, so no two adds meet).  Rows whose
    every value is +-0 are left out, as the kernel leaves them out: a sum
    that starts at +0 is never -0, so adding +-0 changes no bit."""
    seg = inv.reshape(-1).to(torch.int64)
    out = rows.new_zeros((num_segments,) + tuple(rows.shape[1:]))
    if rows.shape[0] == 0:
        return out
    nonzero = (rows.reshape(rows.shape[0], -1) != 0).any(dim=1)
    keep = ((seg >= 0) & (seg < num_segments) & nonzero).nonzero().reshape(-1)
    if keep.numel() == 0:
        return out
    seg = seg.index_select(0, keep)
    src = rows.index_select(0, keep)
    if rows.device.type == "cpu":
        return out.index_add_(0, seg, src)
    return add_in_rounds(out, seg, src)


def add_in_rounds(out: torch.Tensor, seg: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``out.index_add_(0, seg, src)`` with each row of ``out`` receiving
    its adds in the order of ``seg``, on any device: round r adds the r-th
    occurrence of every segment, so no round adds twice to one row."""
    n = seg.numel()
    order = torch.sort(seg, stable=True).indices
    ranked = seg.index_select(0, order)
    pos = torch.arange(n, device=seg.device)
    starts = torch.ones(n, dtype=torch.bool, device=seg.device)
    starts[1:] = ranked[1:] != ranked[:-1]
    first = torch.cummax(torch.where(starts, pos, 0), 0).values
    occurrence = torch.empty_like(pos)
    occurrence[order] = pos - first
    by_round = torch.sort(occurrence, stable=True).indices
    lo = 0
    for count in torch.bincount(occurrence).tolist():
        sel = by_round[lo:lo + count]
        out.index_add_(0, seg.index_select(0, sel), src.index_select(0, sel))
        lo += count
    return out


# The long-run walk's counters.  Each merge_rows launch, and each
# merge_apply launch in merge mode, leaves in its workspace's first words
# (csrc/segment_runs.cuh, kRunWords) the run list's count a bucket, the
# walkers' ticket, and three counters: the long runs walked, the most slots
# one walker took, the longest run's slots.  Reading them syncs, so no step
# reads them: inside ``watch_long_runs()`` each wrapper keeps its last
# launch's words (a view, which holds that launch's workspace until the
# next launch or the block's end) for ``long_run_stats``.

#: segment_runs.cuh: kRunBuckets, then the ticket, kRunsWalked,
#: kBusiestWalker, kLongestRun
_RUN_BUCKETS = 32
_RUN_WORDS = _RUN_BUCKETS + 4
_watching_long_runs = 0
#: kernel name -> the run words of its last launch while watched
_long_run_words: Dict[str, torch.Tensor] = {}


@contextlib.contextmanager
def watch_long_runs():
    """Keep, for ``merge_rows`` and ``merge_apply`` (merge mode), the
    long-run counters of the last launch in the block, which
    :func:`long_run_stats` reads; they are dropped when the block ends."""
    global _watching_long_runs
    with _launch_lock:
        _watching_long_runs += 1
    try:
        yield
    finally:
        with _launch_lock:
            _watching_long_runs -= 1
            if not _watching_long_runs:
                _long_run_words.clear()


def _keep_long_runs(name: str, work: Optional[torch.Tensor]) -> None:
    """Keep ``work``'s run words as kernel ``name``'s last, while watched
    (None: a launch that walked nothing, as merge_rows onto no segment)."""
    if _watching_long_runs:
        with _launch_lock:
            if work is None:
                _long_run_words.pop(name, None)
            else:
                _long_run_words[name] = work[:_RUN_WORDS * 4]


def long_run_stats(name: str = "merge_rows") -> Optional[Dict[str, int]]:
    """The long-run walk of kernel ``name``'s last launch inside
    :func:`watch_long_runs` (None without one): ``listed`` and ``walked``,
    the long runs (longer than 16 slots) put on the run list and walked;
    ``busiest_walker_slots``, the most slots one walker took; and
    ``longest_run_slots``.  Synchronises with the launch's stream."""
    with _launch_lock:
        words = _long_run_words.get(name)
    if words is None:
        return None
    w = [v & 0xFFFFFFFF
         for v in words.view(torch.int32).to(torch.int64).tolist()]
    return {"listed": sum(w[:_RUN_BUCKETS]),
            "walked": w[_RUN_BUCKETS + 1],
            "busiest_walker_slots": w[_RUN_BUCKETS + 2],
            "longest_run_slots": w[_RUN_BUCKETS + 3]}


def _bind_merge_rows(lib: ctypes.CDLL) -> None:
    bind_entry(lib, "merge_rows_workspace_bytes", [_LL, _LL, _LL],
               restype=_LL)
    bind_entry(lib, "merge_rows_f32", [_P, _P, _LL, _LL, _LL, _P, _P, _P])


def _merge_rows_cuda(rows: torch.Tensor, inv: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """Launch the CUDA merge on the current stream; no synchronise."""
    if rows.dtype != torch.float32:
        raise TypeError(f"merge_rows kernel takes float32 rows, got "
                        f"{rows.dtype}")
    if inv.dtype != torch.int32:
        raise TypeError(f"merge_rows kernel takes an int32 inv, got "
                        f"{inv.dtype}")
    m = rows.shape[0]
    if inv.numel() != m:
        raise ValueError(f"merge_rows: {inv.numel()} segment ids for {m} "
                         "rows")
    dev = check_cuda_tensors("merge_rows", rows=rows, inv=inv)
    out = torch.empty((num_segments,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=dev)
    d = rows[0].numel()
    lib = load("merge_rows")
    work = torch.empty((lib.merge_rows_workspace_bytes(m, num_segments, d),),
                       dtype=torch.uint8, device=dev)
    run_kernel("merge_rows", dev, lib.merge_rows_f32, rows.data_ptr(),
               inv.data_ptr(), m, d, num_segments, out.data_ptr(),
               work.data_ptr())
    _keep_long_runs("merge_rows", work if num_segments > 0 else None)
    return out


def _merge_rows_cost(rows, inv, num_segments):
    """The rows and their segment ids read, the segments written."""
    m = rows.shape[0]
    d = rows[0].numel() if m else 1
    return (m * d * rows.element_size() + m * inv.element_size()
            + num_segments * d * rows.element_size()), float(m * d)


register_kernel(
    "merge_rows", phase="merge", plain=merge_rows_plain,
    cuda=_merge_rows_cuda, source="merge_rows.cu", bind=_bind_merge_rows,
    replaces="lightctr_tpu/ops/sparse_kernels.py:317",
    cost=_merge_rows_cost,
)


def merge_rows(rows: torch.Tensor, inv: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Dispatch: duplicate-slot segment merge — ``segment_sum(rows, inv,
    num_segments)`` with the dedup convention's drop semantics for
    out-of-range segments, bit-exact (slot-order sums).  The plain version
    on CPU tensors (any float dtype), the CUDA kernel on CUDA tensors
    (float32 rows, int32 inv)."""
    if inv.device != rows.device:
        raise ValueError(f"merge_rows: rows on {rows.device}, inv on "
                         f"{inv.device}")
    if rows.shape[0] == 0:
        return rows.new_zeros((num_segments,) + tuple(rows.shape[1:]))
    return dispatch("merge_rows", rows.device)(rows, inv, num_segments)


# =========================================================================
# merge_apply: (merge +) scaled sparse Adagrad over the touched rows
# =========================================================================
#
# ``table[uids] -= lr * g * rsqrt(accum[uids] + g^2 + eps)`` with
# ``g = merged / denom``, in place, plus the merged rows' sum of squares.
# ``merged`` is ``rows`` (apply mode, ``inv=None``) or their segment merge
# through ``inv`` (merge mode, the allgather exchange's path).  Replaces
# lightctr_tpu/ops/sparse_kernels.py ``_merge_apply_pallas``; on the card
# each mode is one entry of csrc/merge_apply.cu (with its design note):
# the merge mode sorts and walks the runs as merge_rows does and applies
# each merged row straight to the table, with no [S, d] scratch.


def merge_apply_plain(table, accum, uids, rows, inv, lr, eps, denom):
    """Plain version, literally the JAX package's dispatch and reference:
    for ``inv=None`` the pad mask (padded id-0 slots past slot 0 carry no
    gradient), else the slot-order segment merge; then ``/denom``, the sum
    of squares of every merged row, and ``sparse_adagrad_update`` (in
    place here) with the JAX index rules — a uid in ``[-V, 0)`` wraps to
    ``uid + V``, any other uid outside ``[0, V)`` is dropped from the
    update (it still counts in the sum of squares)."""
    k = uids.shape[0]
    if inv is None:
        valid = ~((uids == 0) & (torch.arange(k, device=uids.device) > 0))
        merged = rows * valid.to(rows.dtype).reshape(
            (-1,) + (1,) * (rows.ndim - 1))
    else:
        merged = merge_rows_plain(rows, inv, k)
    if denom != 1.0:
        # a 0-d tensor divisor keeps this a true division on the card too
        # (a Python scalar divisor becomes a multiply by its reciprocal)
        merged = merged / torch.tensor(denom, dtype=merged.dtype,
                                       device=merged.device)
    sumsq = torch.sum(merged * merged)
    sparse_adagrad_update(table, SparseAdagradState(accum=accum), uids,
                          merged, lr, eps=eps)
    return table, accum, sumsq


def _bind_merge_apply(lib: ctypes.CDLL) -> None:
    bind_entry(lib, "merge_apply_workspace_bytes", [], restype=_LL)
    bind_entry(lib, "merge_apply_f32",
               [_P, _P, _P, _P, _LL, _LL, _LL, _F, _F, _F, _P, _P, _P])
    bind_entry(lib, "merge_apply_merge_workspace_bytes", [_LL, _LL, _LL],
               restype=_LL)
    bind_entry(lib, "merge_apply_merge_f32",
               [_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _F, _F, _F, _P, _P,
                _P])


def _merge_apply_cuda(table, accum, uids, rows, inv, lr, eps, denom):
    """Launch the CUDA apply, or in merge mode the fused merge and apply,
    on the current stream, in place on ``table`` and ``accum``; no
    synchronise.  ``sumsq`` stays on the card.  The launch counts under
    ``merge_apply`` and under its mode (``variant_launches("merge_apply")``:
    ``apply`` or ``merge``)."""
    if not (table.dtype == accum.dtype == rows.dtype == torch.float32):
        raise TypeError("merge_apply kernel takes float32 table, accum and "
                        f"rows, got {table.dtype}, {accum.dtype}, "
                        f"{rows.dtype}")
    if uids.dtype != torch.int32:
        raise TypeError(f"merge_apply kernel takes int32 uids, got "
                        f"{uids.dtype}")
    if accum.shape != table.shape:
        raise ValueError(f"merge_apply: accum {tuple(accum.shape)} != table "
                         f"{tuple(table.shape)}")
    vocab = table.shape[0]
    d = table[0].numel() if vocab else 1
    s = uids.numel()
    dev = check_cuda_tensors("merge_apply", table=table, accum=accum,
                             uids=uids, rows=rows)
    lib = load("merge_apply")
    sumsq = torch.empty((), dtype=torch.float32, device=dev)
    if inv is not None:
        # merge mode: the slot-order segment merge fused into the apply
        if inv.dtype != torch.int32:
            raise TypeError(f"merge_apply kernel takes an int32 inv, got "
                            f"{inv.dtype}")
        m = rows.shape[0]
        if inv.numel() != m or rows.numel() != m * d:
            raise ValueError(f"merge_apply: {inv.numel()} segment ids and "
                             f"{rows.numel()} gradient values for {m} rows "
                             f"of width {d}")
        check_cuda_tensors("merge_apply", rows=rows, inv=inv)
        work = torch.empty((lib.merge_apply_merge_workspace_bytes(m, s, d),),
                           dtype=torch.uint8, device=dev)
        run_kernel("merge_apply", dev, lib.merge_apply_merge_f32,
                   table.data_ptr(), accum.data_ptr(), uids.data_ptr(),
                   rows.data_ptr(), inv.data_ptr(), vocab, d, s, m, lr, eps,
                   denom, sumsq.data_ptr(), work.data_ptr(), variant="merge")
        _keep_long_runs("merge_apply", work)
        return table, accum, sumsq
    if rows.numel() != s * d:
        raise ValueError(f"merge_apply: {rows.numel()} gradient values for "
                         f"{s} uids of width {d}")
    work = torch.empty((lib.merge_apply_workspace_bytes(),),
                       dtype=torch.uint8, device=dev)
    run_kernel("merge_apply", dev, lib.merge_apply_f32, table.data_ptr(),
               accum.data_ptr(), uids.data_ptr(), rows.data_ptr(), vocab, d,
               s, lr, eps, denom, sumsq.data_ptr(), work.data_ptr(),
               variant="apply")
    return table, accum, sumsq


def _merge_apply_cost(table, accum, uids, rows, inv, lr, eps, denom):
    """The touched rows' weights and accumulators read and written, their
    gradient rows (all M of them in the merge mode) and the uids read; a
    pad slot (uid 0 past slot 0) reads its uid only."""
    s = uids.numel()
    d = table[0].numel() if table.shape[0] else 1
    real = int(((uids != 0) | (torch.arange(s, device=uids.device) == 0))
               .sum())
    es = table.element_size()
    nbytes = real * d * es * 4 + s * uids.element_size()
    if inv is None:
        nbytes += real * d * es
    else:
        m = rows.shape[0]
        nbytes += m * d * es + m * inv.element_size()
    return nbytes, float(6 * real * d)


register_kernel(
    "merge_apply", phase="apply", plain=merge_apply_plain,
    cuda=_merge_apply_cuda, source="merge_apply.cu", bind=_bind_merge_apply,
    replaces="lightctr_tpu/ops/sparse_kernels.py:593",
    cost=_merge_apply_cost,
)


def merge_apply(
    table: torch.Tensor,
    accum: torch.Tensor,
    uids: torch.Tensor,
    rows: torch.Tensor,
    inv: Optional[torch.Tensor] = None,
    *,
    lr: float,
    eps: float = 1e-7,
    denom: float = 1.0,
):
    """Dispatch: (segment merge +) scaled sparse Adagrad over the touched
    rows of ``table``/``accum``, **in place** -> ``(table, accum, sumsq)``.

    ``uids`` [S] follow the dedup convention (sorted unique, padding
    repeats id 0); ``rows`` is either per-uid rows [S, ...] (``inv=None``)
    or the pre-merge [M, ...] payload with its segment map ``inv`` [M].
    ``denom`` scales the merged rows before the apply; ``sumsq`` is their
    sum of squares (the health gradient norm's share).  Padded id-0 slots
    are zero-gradient by contract.  A uid in ``[-V, 0)`` wraps to
    ``uid + V`` and any other uid outside the table is dropped from the
    update, as the JAX reference's scatter does.  The plain version on CPU
    tensors, the CUDA kernel on CUDA tensors (both modes, one launch each;
    the merge mode's kernel merges and applies in one pass)."""
    if uids.device != table.device:
        raise ValueError(f"merge_apply: table on {table.device}, uids on "
                         f"{uids.device}")
    return dispatch("merge_apply", table.device)(
        table, accum, uids, rows, inv, lr, eps, denom)


# =========================================================================
# quantize_pack: float payload -> quantile codes
# =========================================================================
#
# ``searchsorted(boundaries, x, side='left')`` as uint8 (<= 8 bits) or
# uint16 codes — the encode of every coded collective.  Replaces
# lightctr_tpu/ops/sparse_kernels.py ``_qp_pallas`` (``_qp_kernel``,
# ``_qp_search_kernel``); csrc/quantize_pack.cu has the kernel (float4
# lanes on a persistent grid over csrc/quantile_search.cuh's searches) and
# its design note.


def search_design(bits: int) -> str:
    """The search a quantize kernel runs for a ``bits``-wide table (its
    launches' variant): ``tree``, the whole table as a tree in shared
    memory, up to 8 bits; ``split``, a top tree in shared memory then one
    segment of the boundaries, above."""
    return "tree" if bits <= 8 else "split"


def quantize_pack_plain(table, x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``quantize.compress`` (NaN takes the top code, as in
    the JAX reference)."""
    return quantize.compress(table, x)


def _bind_quantize_pack(lib: ctypes.CDLL) -> None:
    for sym in ("quantize_pack_u8", "quantize_pack_u16"):
        bind_entry(lib, sym, [_P, _LL, _P, _LL, _P, _P])


def check_table(name: str, table, dev: torch.device) -> None:
    """A quantile table for a kernel: contiguous float32 boundaries and
    values on ``dev``, 2^bits values and 2^bits - 1 boundaries."""
    nv = table.values.numel()
    if not 1 <= table.bits <= 16 or nv != 1 << table.bits \
            or table.boundaries.numel() != nv - 1:
        raise ValueError(f"{name}: a {table.bits}-bit table needs "
                         f"{1 << table.bits} values and one boundary fewer, "
                         f"got {nv} and {table.boundaries.numel()}")
    for what, t in (("boundaries", table.boundaries),
                    ("values", table.values)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32 table {what}, got "
                            f"{t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous table {what} "
                             f"on {dev}, got {t.device}")


def _quantize_pack_cuda(table, x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA encode on the current stream; no synchronise."""
    if x.dtype != torch.float32:
        raise TypeError(f"quantize_pack kernel takes a float32 payload, got "
                        f"{x.dtype}")
    dev = check_cuda_tensors("quantize_pack", x=x)
    check_table("quantize_pack", table, dev)
    codes = torch.empty(x.shape, dtype=quantize.code_dtype(table.bits),
                        device=dev)
    if x.numel() == 0:
        return codes
    lib = load("quantize_pack")
    fn = lib.quantize_pack_u8 if table.bits <= 8 else lib.quantize_pack_u16
    run_kernel("quantize_pack", dev, fn, table.boundaries.data_ptr(),
               table.boundaries.numel(), x.data_ptr(), x.numel(),
               codes.data_ptr(), variant=search_design(table.bits))
    return codes


def _quantize_pack_cost(table, x):
    """The payload read, the codes written."""
    cb = 1 if table.bits <= 8 else 2
    return x.numel() * (x.element_size() + cb), 0.0


register_kernel(
    "quantize_pack", phase="pack", plain=quantize_pack_plain,
    cuda=_quantize_pack_cuda, source="quantize_pack.cu",
    bind=_bind_quantize_pack,
    replaces="lightctr_tpu/ops/sparse_kernels.py:836",
    cost=_quantize_pack_cost,
)


def quantize_pack(table, x: torch.Tensor) -> torch.Tensor:
    """Dispatch: float payload -> quantile codes, bit-identical to
    ``quantize.compress`` (the wire pack every coded collective hop
    ships), at any width up to 16 bits.  The plain version on a CPU
    tensor, the CUDA kernel on a CUDA tensor."""
    return dispatch("quantize_pack", x.device)(table, x)


def quantize_pack_packed(table, x: torch.Tensor) -> torch.Tensor:
    """:func:`quantize_pack` plus the sub-byte WIRE form: 4-bit-and-under
    tables bit-pack two codes per byte (``quantize.pack_nibbles``); wider
    tables return their codes unchanged.  Receiver side:
    ``unpack_nibbles(packed, x.numel())`` then ``quantize.extract``."""
    codes = quantize_pack(table, x)
    if table.bits <= 4:
        return quantize.pack_nibbles(codes)
    return codes


# =========================================================================
# quantize_pack_ef: EF-folded pack
# =========================================================================
#
# ``val = rows + carried*mask``, ``codes = compress(val)``, ``delta = (val -
# extract(codes) - carried)*mask`` in one pass — the EF encode whose caller
# scatters ``delta`` back itself (the kernel bench, tools/
# sparse_kernel_bench.py).  Replaces lightctr_tpu/ops/sparse_kernels.py
# ``_qp_ef_pallas`` / ``_qp_ef_kernel``; csrc/quantize_pack_ef.cu has the
# kernel and its design note.


def quantize_pack_ef_plain(table, rows, carried, mask):
    """Plain version, literally the JAX reference ``_qp_ef_reference``:
    compensate with the carry, encode (NaN takes the top code), decode,
    fresh error.  Returns ``(codes, delta)``."""
    val = rows + carried * mask
    codes = quantize.compress(table, val)
    dec = quantize.extract(table, codes)
    return codes, (val - dec - carried) * mask


def _bind_quantize_pack_ef(lib: ctypes.CDLL) -> None:
    for sym in ("quantize_pack_ef_u8", "quantize_pack_ef_u16"):
        bind_entry(lib, sym, [_P, _LL, _P, _P, _P, _P, _LL, _LL, ctypes.c_int,
                              _P, _P, _P])


def _quantize_pack_ef_cuda(table, rows, carried, mask):
    """Launch the CUDA EF-folded pack on the current stream; no
    synchronise.  A ``mask`` constant along every dim but the first goes
    to the kernel as one value per row, any other as one per value."""
    if not (rows.dtype == carried.dtype == torch.float32):
        raise TypeError("quantize_pack_ef kernel takes float32 rows and "
                        f"carried, got {rows.dtype}, {carried.dtype}")
    if carried.shape != rows.shape:
        raise ValueError(f"quantize_pack_ef: carried {tuple(carried.shape)} "
                         f"!= rows {tuple(rows.shape)}")
    try:
        mb = torch.broadcast_to(mask.to(torch.float32), rows.shape)
    except RuntimeError as e:
        raise ValueError(f"quantize_pack_ef: mask {tuple(mask.shape)} does "
                         f"not broadcast to rows {tuple(rows.shape)}") from e
    n = rows.numel()
    p = rows.shape[0] if rows.dim() else 1
    per_row = rows.dim() > 1 and all(
        st == 0 or sz == 1 for st, sz in zip(mb.stride()[1:], mb.shape[1:]))
    m = (mb[(slice(None),) + (0,) * (rows.dim() - 1)] if per_row
         else mb).contiguous()
    dev = check_cuda_tensors("quantize_pack_ef", rows=rows, carried=carried,
                             mask=m)
    check_table("quantize_pack_ef", table, dev)
    codes = torch.empty(rows.shape, dtype=quantize.code_dtype(table.bits),
                        device=dev)
    delta = torch.empty(rows.shape, dtype=torch.float32, device=dev)
    if n == 0:
        return codes, delta
    lib = load("quantize_pack_ef")
    fn = (lib.quantize_pack_ef_u8 if table.bits <= 8
          else lib.quantize_pack_ef_u16)
    run_kernel("quantize_pack_ef", dev, fn, table.boundaries.data_ptr(),
               table.boundaries.numel(), table.values.data_ptr(),
               rows.data_ptr(), carried.data_ptr(), m.data_ptr(), p, n // p,
               0 if per_row else 1, codes.data_ptr(), delta.data_ptr(),
               variant=search_design(table.bits))
    return codes, delta


def _quantize_pack_ef_cost(table, rows, carried, mask):
    """Rows, carry and mask read, codes and delta written."""
    cb = 1 if table.bits <= 8 else 2
    n = rows.numel()
    return n * (4 + 4 + cb + 4) + mask.numel() * mask.element_size(), 0.0


register_kernel(
    "quantize_pack_ef", phase="pack", plain=quantize_pack_ef_plain,
    cuda=_quantize_pack_ef_cuda, source="quantize_pack_ef.cu",
    bind=_bind_quantize_pack_ef,
    replaces="lightctr_tpu/ops/sparse_kernels.py:944",
    cost=_quantize_pack_ef_cost,
)


def quantize_pack_ef(table, rows: torch.Tensor, carried: torch.Tensor,
                     mask: torch.Tensor):
    """Dispatch: EF-folded payload pack -> ``(codes, delta)`` where ``val =
    rows + carried*mask``, ``codes = compress(val)`` and ``delta = (val -
    extract(codes) - carried)*mask`` — the fresh error-feedback
    contribution the caller scatters back at the rows' table slots.
    ``mask`` is anything that broadcasts to ``rows.shape``.  The plain
    version on CPU tensors, the CUDA kernel on CUDA tensors (float32 rows
    and carry of one shape; 8 and 16 bits alike, bit-identical to the
    plain version)."""
    if carried.device != rows.device or mask.device != rows.device:
        raise ValueError(f"quantize_pack_ef: rows on {rows.device}, carried "
                         f"on {carried.device}, mask on {mask.device}")
    return dispatch("quantize_pack_ef", rows.device)(table, rows, carried,
                                                     mask)


# =========================================================================
# quantize_pack_ef_update: EF-compensated pack with the carry write-back
# =========================================================================
#
# One pass per slot row: ``car = residual[uid]``, ``val = row + car*m``,
# the code, ``dec = values[code]`` and ``residual[uid] = car + ((val - dec)
# - car)*m`` in place — the fixed-range sparse exchange's error feedback.
# Replaces lightctr_tpu/ops/sparse_kernels.py ``_qp_ef_update_pallas`` /
# ``_qp_ef_update_kernel``; csrc/quantize_pack_ef_update.cu has the kernel
# and its design note.


def quantize_pack_ef_update_plain(table, rows, uids, residual, mask):
    """Plain version, literally the JAX reference (in place on
    ``residual``): gather the carry (a uid in ``[-V, 0)`` wraps, any other
    uid outside the table reads NaN, as ``jnp.take`` fills), compensate,
    encode, decode, and scatter-add the fresh error ``((val - dec) -
    carried) * mask`` back at the rows' slots (out-of-table slots dropped).
    Returns ``(codes, residual, dec)``."""
    vocab = residual.shape[0]
    idx = torch.where(uids < 0, uids + vocab, uids).to(torch.int64)
    inside = (idx >= 0) & (idx < vocab)
    carried = residual.index_select(0, idx.clamp(0, max(vocab - 1, 0)))
    carried = torch.where(
        inside.reshape((-1,) + (1,) * (carried.ndim - 1)), carried,
        torch.full_like(carried, float("nan")))
    m = mask.to(rows.dtype)
    val = rows + carried * m
    codes = quantize.compress(table, val)
    dec = quantize.extract(table, codes)
    delta = (val - dec - carried) * m
    sel = inside.nonzero().reshape(-1)
    residual.index_add_(0, idx.index_select(0, sel),
                        delta.index_select(0, sel))
    return codes, residual, dec


def _bind_quantize_pack_ef_update(lib: ctypes.CDLL) -> None:
    for sym in ("quantize_pack_ef_update_u8", "quantize_pack_ef_update_u16"):
        bind_entry(lib, sym, [_P, _LL, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                              _P, _P, _P])


def _quantize_pack_ef_update_cuda(table, rows, uids, residual, mask):
    """Launch the CUDA EF pack on the current stream, in place on
    ``residual``; no synchronise.  ``mask`` holds one value per slot."""
    if not (rows.dtype == residual.dtype == torch.float32):
        raise TypeError("quantize_pack_ef_update kernel takes float32 rows "
                        f"and residual, got {rows.dtype}, {residual.dtype}")
    if uids.dtype != torch.int32:
        raise TypeError(f"quantize_pack_ef_update kernel takes int32 uids, "
                        f"got {uids.dtype}")
    s = uids.numel()
    vocab = residual.shape[0]
    d = residual[0].numel() if vocab else 1
    if tuple(rows.shape) != (s,) + tuple(residual.shape[1:]):
        raise ValueError(f"quantize_pack_ef_update: rows {tuple(rows.shape)} "
                         f"for {s} uids into a residual "
                         f"{tuple(residual.shape)}")
    if mask.numel() != s:
        raise ValueError(f"quantize_pack_ef_update kernel takes one mask "
                         f"value per slot, got {tuple(mask.shape)}")
    m = mask.reshape(s).to(torch.float32).contiguous()
    dev = check_cuda_tensors("quantize_pack_ef_update", rows=rows, uids=uids,
                             residual=residual, mask=m)
    check_table("quantize_pack_ef_update", table, dev)
    codes = torch.empty(rows.shape, dtype=quantize.code_dtype(table.bits),
                        device=dev)
    dec = torch.empty(rows.shape, dtype=torch.float32, device=dev)
    if rows.numel() == 0:
        return codes, residual, dec
    lib = load("quantize_pack_ef_update")
    fn = (lib.quantize_pack_ef_update_u8 if table.bits <= 8
          else lib.quantize_pack_ef_update_u16)
    run_kernel("quantize_pack_ef_update", dev, fn,
               table.boundaries.data_ptr(), table.boundaries.numel(),
               table.values.data_ptr(), rows.data_ptr(), uids.data_ptr(),
               residual.data_ptr(), m.data_ptr(), s, d, vocab,
               codes.data_ptr(), dec.data_ptr(),
               variant=search_design(table.bits))
    return codes, residual, dec


def _quantize_pack_ef_update_cost(table, rows, uids, residual, mask):
    """Rows, uids and mask read, the real slots' carries read and written,
    codes and decoded values written."""
    cb = 1 if table.bits <= 8 else 2
    k = uids.numel()
    d = rows[0].numel() if rows.shape[0] else 1
    real = int((mask.reshape(-1) != 0).sum())
    return (k * d * 4 + real * d * 4 + k * 8 + k * d * (cb + 4)
            + real * d * 4), 0.0


register_kernel(
    "quantize_pack_ef_update", phase="pack",
    plain=quantize_pack_ef_update_plain, cuda=_quantize_pack_ef_update_cuda,
    source="quantize_pack_ef_update.cu", bind=_bind_quantize_pack_ef_update,
    replaces="lightctr_tpu/ops/sparse_kernels.py:1064",
    cost=_quantize_pack_ef_update_cost,
)


def quantize_pack_ef_update(table, rows: torch.Tensor, uids: torch.Tensor,
                            residual: torch.Tensor, mask: torch.Tensor):
    """Dispatch: EF pack with the residual scatter folded in ->
    ``(codes, residual, dec)``, ``residual`` updated **in place**.  ``rows``
    [S, ...] follow the dedup convention with ``uids`` [S] naming their
    table slots; ``residual`` is the [vocab, ...] carry and ``mask`` the
    per-slot validity (pads neither read into the code nor write the
    carry).  ``uids``/``mask`` must honour the dedup convention — at most
    one unmasked slot per uid.  The plain version on CPU tensors, the CUDA
    kernel on CUDA tensors (8 and 16 bits alike)."""
    if rows.shape[0] == 0:
        return (torch.zeros(rows.shape, dtype=quantize.code_dtype(table.bits),
                            device=rows.device), residual,
                torch.zeros(rows.shape, dtype=torch.float32,
                            device=rows.device))
    return dispatch("quantize_pack_ef_update", rows.device)(
        table, rows, uids, residual, mask)
