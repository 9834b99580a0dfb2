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
nothing.

Ported so far: ``gather_rows`` (``_gather_pallas``), ``dedup_ids``
(``_dedup_pallas``), ``merge_apply`` in its apply mode (``_merge_apply_pallas``
with ``inv=None``) and, registered from ``optim/fused_adagrad.py``,
``fused_adagrad`` (``_adagrad_pallas``).  The JAX package's other Pallas
kernels (merge_rows and merge_apply's merge mode, quantize_pack and its EF
variants, flash attention) are still to be ported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, NamedTuple, Optional

import torch

from lightctr_tpu_torch.embed.table import (
    SparseAdagradState,
    segment_sum,
    sparse_adagrad_update,
)

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
_launch_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_lib_lock = threading.Lock()
#: source file -> nvcc's output of its last build in this process
BUILD_LOGS: Dict[str, str] = {}


def register_kernel(name: str, *, phase: str, plain: Callable,
                    cuda: Callable, source: str,
                    bind: Callable[[ctypes.CDLL], None],
                    replaces: str) -> None:
    """Register a hand-written kernel with its plain PyTorch version."""
    if phase not in KERNEL_PHASES:
        raise ValueError(f"unknown kernel phase {phase!r}")
    KERNELS[name] = KernelDef(name, phase, plain, cuda, source, bind,
                              replaces)
    with _launch_lock:
        _launches.setdefault(name, 0)


def launches(name: Optional[str] = None):
    """Launch count of kernel ``name`` — or a dict of all counts."""
    with _launch_lock:
        return dict(_launches) if name is None else _launches[name]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    with _launch_lock:
        for k in _launches:
            _launches[k] = 0


def _count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


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
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        h = hashlib.sha256(f.read())
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
    return so_path


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lib_lock:
        lib = _libs.get(name)
    if lib is not None:
        return lib
    kd = KERNELS[name]
    lib = ctypes.CDLL(compile_source(kd.source))
    kd.bind(lib)
    with _lib_lock:
        return _libs.setdefault(name, lib)


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
    on the CPU, the CUDA wrapper on a CUDA device."""
    kd = KERNELS[name]
    if device.type == "cpu":
        return kd.plain
    if device.type == "cuda":
        return kd.cuda
    raise ValueError(f"{name}: no implementation for device {device}")


def run_kernel(name: str, device: torch.device, entry, *args) -> None:
    """Call the C entry ``entry(*args, stream)`` on ``device``'s current
    stream (no synchronise); raise on a non-zero CUDA error, else count
    one launch of kernel ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count_launch(name)


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


def _gather_rows_cuda(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; no synchronise."""
    if block.dtype != torch.float32:
        raise TypeError(f"gather_rows kernel takes float32 rows, "
                        f"got {block.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows kernel takes int32/int64 indices, "
                        f"got {idx.dtype}")
    dev = check_cuda_tensors("gather_rows", block=block, idx=idx)
    rows = block.shape[0]
    n = idx.numel()
    out = torch.empty((n,) + tuple(block.shape[1:]), dtype=block.dtype,
                      device=block.device)
    if out.numel() == 0:
        return out
    d = out.numel() // n
    lib = load("gather_rows")
    fn = (lib.gather_rows_f32_i32 if idx.dtype == torch.int32
          else lib.gather_rows_f32_i64)
    run_kernel("gather_rows", dev, fn, block.data_ptr(), idx.data_ptr(),
               out.data_ptr(), rows, d, n)
    return out


register_kernel(
    "gather_rows", phase="gather", plain=gather_rows_plain,
    cuda=_gather_rows_cuda, source="gather_rows.cu", bind=_bind_gather_rows,
    replaces="lightctr_tpu/ops/sparse_kernels.py:733",
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
# has the kernel (a bitonic sort and a scan, not the TPU's O(K^2) rank
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
    bind_entry(lib, "dedup_ids_workspace_bytes", [_LL], restype=_LL)
    bind_entry(lib, "dedup_ids_i32", [_P, _LL, _LL, _P, _P, _P, _P, _P])


def _dedup_ids_cuda(ids: torch.Tensor, size: int):
    """Launch the CUDA dedup on the current stream; no synchronise.  The
    count stays on the card."""
    if ids.dtype != torch.int32:
        raise TypeError(f"dedup_ids kernel takes int32 ids, got {ids.dtype} "
                        "(cast first, as the sparse trainer does)")
    dev = check_cuda_tensors("dedup_ids", ids=ids)
    k = ids.numel()
    lib = load("dedup_ids")
    work = torch.empty((lib.dedup_ids_workspace_bytes(k),), dtype=torch.uint8,
                       device=dev)
    uids = torch.empty((size,), dtype=torch.int32, device=dev)
    inv = torch.empty((k,), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    run_kernel("dedup_ids", dev, lib.dedup_ids_i32, ids.data_ptr(), k, size,
               uids.data_ptr(), inv.data_ptr(), count.data_ptr(),
               work.data_ptr())
    return uids, inv, count


register_kernel(
    "dedup_ids", phase="dedup", plain=dedup_ids_plain, cuda=_dedup_ids_cuda,
    source="dedup_ids.cu", bind=_bind_dedup_ids,
    replaces="lightctr_tpu/ops/sparse_kernels.py:227",
)


def dedup_ids(ids: torch.Tensor, size: Optional[int] = None):
    """Dispatch: unique+inverse over one id stream -> ``(uids, inv,
    count)``.  ``size`` defaults to ``len(ids)`` (no truncation); with
    ``size < count`` the unique array is cut while ``inv`` keeps full
    ranks.  The plain version on a CPU tensor (any integer dtype), the CUDA
    kernel on a CUDA tensor (int32 only: it raises ``TypeError`` for
    int64)."""
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
# merge_apply: scaled sparse Adagrad over the touched rows
# =========================================================================
#
# ``table[uids] -= lr * g * rsqrt(accum[uids] + g^2 + eps)`` with
# ``g = rows / denom``, in place, plus the rows' sum of squares.  Replaces
# lightctr_tpu/ops/sparse_kernels.py ``_merge_apply_pallas`` in its apply
# mode (``inv=None``); csrc/merge_apply.cu has the kernel and its design
# note.  The merge mode (``inv`` given: duplicate rows segment-summed
# first, TPU kernel ``_merge_pallas``) runs in the plain version only; its
# kernel comes with the multi-GPU slice.


def merge_apply_plain(table, accum, uids, rows, inv, lr, eps, denom):
    """Plain version: the pad mask of the JAX dispatcher (for ``inv=None``:
    padded id-0 slots past slot 0 carry no gradient), then literally
    ``_merge_apply_reference`` — optional segment-sum, ``/denom``, the sum
    of squares, then ``sparse_adagrad_update`` (in place here).  A uid
    outside ``[0, len(table))`` is dropped, its row out of the update and
    the sum, as the kernel drops it."""
    k = uids.shape[0]
    inside = (uids >= 0) & (uids < table.shape[0])
    if inv is None:
        valid = inside & ~((uids == 0) & (torch.arange(k, device=uids.device)
                                          > 0))
        merged = rows * valid.to(rows.dtype).reshape(
            (-1,) + (1,) * (rows.ndim - 1))
    else:
        merged = segment_sum(rows, inv, k)
        merged = merged * inside.to(merged.dtype).reshape(
            (-1,) + (1,) * (merged.ndim - 1))
    # a dropped slot becomes a zero row at id 0, like a pad
    uids = torch.where(inside, uids, torch.zeros_like(uids))
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


def _merge_apply_cuda(table, accum, uids, rows, inv, lr, eps, denom):
    """Launch the CUDA apply on the current stream, in place on ``table``
    and ``accum``; no synchronise.  ``sumsq`` stays on the card."""
    if inv is not None:
        raise NotImplementedError(
            "merge_apply kernel: the merge mode (inv given, a segment-sum "
            "of duplicate rows, the TPU kernel _merge_pallas) comes with "
            "the multi-GPU slice; this kernel applies per-uid rows "
            "(inv=None)")
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
    rows = rows.reshape(s, d)
    dev = check_cuda_tensors("merge_apply", table=table, accum=accum,
                             uids=uids, rows=rows)
    lib = load("merge_apply")
    work = torch.empty((lib.merge_apply_workspace_bytes(),),
                       dtype=torch.uint8, device=dev)
    sumsq = torch.empty((), dtype=torch.float32, device=dev)
    run_kernel("merge_apply", dev, lib.merge_apply_f32, table.data_ptr(),
               accum.data_ptr(), uids.data_ptr(), rows.data_ptr(), vocab, d,
               s, lr, eps, denom, sumsq.data_ptr(), work.data_ptr())
    return table, accum, sumsq


register_kernel(
    "merge_apply", phase="apply", plain=merge_apply_plain,
    cuda=_merge_apply_cuda, source="merge_apply.cu", bind=_bind_merge_apply,
    replaces="lightctr_tpu/ops/sparse_kernels.py:593",
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
    """Dispatch: scaled sparse Adagrad over the touched rows of
    ``table``/``accum``, **in place** -> ``(table, accum, sumsq)``.

    ``uids`` [S] follow the dedup convention (sorted unique, padding
    repeats id 0); ``rows`` is either per-uid rows [S, ...] (``inv=None``)
    or the pre-merge [M, ...] payload with its segment map ``inv`` [M].
    ``denom`` scales the merged rows before the apply; ``sumsq`` is their
    sum of squares (the health gradient norm's share).  Padded id-0 slots
    are zero-gradient by contract.  The plain version on CPU tensors (both
    modes), the CUDA kernel on CUDA tensors (``inv=None`` only; it raises
    ``NotImplementedError`` for the merge mode)."""
    if uids.device != table.device:
        raise ValueError(f"merge_apply: table on {table.device}, uids on "
                         f"{uids.device}")
    return dispatch("merge_apply", table.device)(
        table, accum, uids, rows, inv, lr, eps, denom)
