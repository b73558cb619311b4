"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into its own content-hashed shared
library under ``build/`` at the repository root, at first use, and loads
with ``ctypes``: a plain C interface, no PyTorch headers, so a build
takes seconds. ``build_all`` starts one ``nvcc`` per source, all at
once. Nothing here runs at import time, so the package imports where
``nvcc`` and CUDA are absent.

Every pointer and the stream cross as ``c_void_p``; every C entry point
returns ``cudaGetLastError()`` after its launches and ``check`` raises
if it is not 0.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on
the card (never the plain-version calls): a run reads it to show which
kernels its path went through. ``lp_move_stacked`` counts the stacked
calls of the ``lp_move`` library (several requests' chunks at once)
apart from its solo calls; ``lp_move_dist`` / ``bal_scores_dist`` (and
their ``_heavy_dist``) the distributed engine's forms (the ``nbud``
admission, the ghost label table) apart from the single-device ones.

Building, loading and counting are safe under threads (a session runs
requests on a thread pool): one lock spans ``load``'s check, build and
``CDLL`` and all of ``build_all``, so concurrent first loads compile a
library once. Across processes (a mesh's ranks load the libraries at
once) the compile runs under an exclusive lock on ``build/.lock`` too,
and a library another process built meanwhile is not built again;
temporary build files are named by process and thread.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build"
SOURCES = ("lp_move", "seg_merge", "bal_round", "lp_gain", "bsr_spmm",
           "embedding_bag")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"lp_move": 0, "lp_move_heavy": 0,
                            "lp_move_stacked": 0, "lp_move_dist": 0,
                            "lp_move_heavy_dist": 0, "seg_merge": 0,
                            "bal_scores": 0, "bal_scores_heavy": 0,
                            "bal_scores_dist": 0,
                            "bal_scores_heavy_dist": 0,
                            "greedy_pick": 0, "lp_gain": 0, "bsr_spmm": 0,
                            "embedding_bag": 0}

_libs: Dict[str, ctypes.CDLL] = {}
# guards BUILD_DIR's files, ``_libs`` and ``LAUNCHES``
_LOCK = threading.Lock()


def count_launch(kernel: str) -> None:
    with _LOCK:
        LAUNCHES[kernel] += 1


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for part in (CSRC / "common.cuh", CSRC / f"{name}.cu"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every library not built yet, one ``nvcc`` per source in
    parallel. Returns the wall seconds spent; raises on a failed build
    with the compiler's output."""
    with _LOCK:
        return _build_all(names)


@contextlib.contextmanager
def _across_processes():
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _build_all(names) -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if all(_target(name).exists() for name in names):
        return time.perf_counter() - t0
    with _across_processes():
        _compile(names)
    return time.perf_counter() - t0


def _compile(names) -> None:
    nvcc = None
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs.append((name, out, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build_log(name: str) -> Optional[str]:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) of the library's last build, if it was built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name``; builds it first if needed. Every
    entry point returns ``int`` (a ``cudaError_t``)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _libs.get(name)
        if lib is None:
            _build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {err}")


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint32


def ptr(t) -> int:
    """Device pointer of a tensor (or 0 for ``None``)."""
    return 0 if t is None else t.data_ptr()


def stream_of(t) -> int:
    """The handle of the current stream of ``t``'s CUDA device (the raw
    query: ``torch.cuda.current_stream`` builds a Stream object, which
    costs more host time than a small launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_index_range(what: str, t, hi: int) -> None:
    """Raise unless every entry of the integer tensor ``t`` lies in
    [0, hi). On the card this reads two numbers back, so it waits for
    the stream."""
    if t.numel() == 0:
        return
    import torch
    lo, top = torch.stack(t.aminmax()).tolist()
    if lo < 0 or top >= hi:
        raise ValueError(f"{what}: index out of range [0, {hi}): found "
                         f"{lo if lo < 0 else top}")


def require(what: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the checks a kernel cannot make itself)."""
    if t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
