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

Ported so far: ``gather_rows`` (``_gather_pallas``).  The JAX package's
other Pallas kernels (dedup, merge, merge_apply, quantize_pack and its EF
variants, fused Adagrad, flash attention) are still to be ported.
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


def _dispatch(name: str, device: torch.device) -> Callable:
    kd = KERNELS[name]
    if device.type == "cpu":
        return kd.plain
    if device.type == "cuda":
        return kd.cuda
    raise ValueError(f"{name}: no implementation for device {device}")


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


def _bind_gather_rows(lib: ctypes.CDLL) -> None:
    for sym in ("gather_rows_f32_i32", "gather_rows_f32_i64"):
        fn = getattr(lib, sym)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]


def _gather_rows_cuda(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; no synchronise."""
    if block.dtype != torch.float32:
        raise TypeError(f"gather_rows kernel takes float32 rows, "
                        f"got {block.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows kernel takes int32/int64 indices, "
                        f"got {idx.dtype}")
    if not (block.is_cuda and idx.device == block.device):
        raise ValueError("gather_rows kernel needs block and idx on one "
                         f"CUDA device, got {block.device} / {idx.device}")
    if not (block.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows kernel needs contiguous block and idx")
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
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream(block.device).cuda_stream
        err = fn(block.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, d,
                 n, stream)
    if err != 0:
        raise RuntimeError(f"gather_rows launch failed: CUDA error {err}")
    _count_launch("gather_rows")
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
    return _dispatch("gather_rows", block.device)(block, idx)
