"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``aclswarm_torch/csrc/*.cu`` has a plain ``extern "C"`` interface and
no PyTorch headers. Each source compiles to an object with its own
``nvcc``, all started together, and one more ``nvcc`` links the objects
into one shared library: seconds in all. The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources
and the flags, so an edited source rebuilds and an unchanged tree is
reused. Nothing here runs at import: the CPU tests import every module on
machines without ``nvcc``.

Every pointer and the stream cross the boundary as ``ctypes.c_void_p``;
each entry point returns ``cudaGetLastError()`` and `launch` raises on a
non-zero code. `LAUNCHES` counts the kernel launches each wrapper made
(`count_launch`, under a lock: serve workers launch from several threads).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# compile flags of each source; the link adds ``-shared``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes; the stream is the last argument of each
_ENTRY = {
    "sinkhorn_log_launch": (_P, _P, _P, _P, _I, _F, _I, _F,
                            ctypes.POINTER(_I), _P),
    "round_dominant_launch": (_P, _P, _P, _P, _I, _I, ctypes.POINTER(_I),
                              _P),
    # a trial axis: B problems, the batch count before the size
    "sinkhorn_log_batched_launch": (_P, _P, _P, _P, _I, _I, _F, _I, _F,
                                    ctypes.POINTER(_I), _P),
    "round_dominant_batched_launch": (_P, _P, _P, _P, _I, _I, _I,
                                      ctypes.POINTER(_I), _P),
    # (packed, comm, out, batch, n senders, r receivers, w targets)
    "flood_merge_launch": (_P, _P, _P, _I, _I, _I, _I, _P),
    # earlier designs, which chip_smoke.py times the current ones against;
    # sinkhorn_log_launch also runs the multi-launch design past its
    # shared-memory limit
    "sinkhorn_log_multi_launch": (_P, _P, _P, _P, _I, _F, _I, _F,
                                  ctypes.POINTER(_I), _P),
    "round_dominant_single_block_launch": (_P, _P, _P, _I, _I, _I, _P),
    "flood_merge_bytemask_launch": (_P, _P, _P, _I, _I, _I, _P),
}

# kernel launches per wrapper since the last `reset_launches`
LAUNCHES = {"sinkhorn_log": 0, "round_dominant": 0, "flood_merge": 0}
_LAUNCHES_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
# what this process loaded: `build`'s return ({"library", "cached", ...});
# empty until the first launch
LOADED: dict = {}


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str, k: int = 1) -> None:
    """Add ``k`` launches to wrapper ``name``'s count (thread-safe)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += k


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then the
    toolkit's conventional install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the aclswarm_torch CUDA kernels")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"aclswarm_kernels-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source into the library, one ``nvcc`` per source run
    in parallel and one link, unless it is built already. Returns
    {"library", "seconds", "cached", "ptxas"} and raises with the
    compiler's output if a step fails."""
    target = lib_path()
    if target.exists():
        return {"library": str(target), "seconds": 0.0, "cached": True,
                "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{target.stem}.{os.getpid()}"
    t0 = time.perf_counter()  # torchcheck: disable=JC004 times the one-off build
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    try:
        for src, p, log in zip(_sources(), procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"CUDA kernel build failed: nvcc exit "
                                   f"{p.returncode} on {src.name}:\n{log}")
        link = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed (nvcc exit "
                               f"{link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, target)    # atomic: a concurrent build never loads
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return {"library": str(target), "seconds": time.perf_counter() - t0,  # torchcheck: disable=JC004 times the one-off build
            "cached": False, "ptxas": "\n".join(x.strip() for x in logs)}


def _lib() -> ctypes.CDLL:
    """The loaded library, built on first use; one thread builds and
    loads it while any other waits."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            info = build()
            lib = ctypes.CDLL(info["library"])
            for symbol, argtypes in _ENTRY.items():
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            LOADED.update(library=info["library"], cached=info["cached"])
            _LIB = lib
        return _LIB


def check(t, what: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` — what every kernel takes, and nothing else."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def launch(symbol: str, device, *args) -> None:
    """Call entry point ``symbol`` on ``device``'s current stream (appended
    as the last argument); raise on a CUDA error code."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, symbol)(*args, stream)
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{symbol} failed: CUDA error {err} ({msg})")
