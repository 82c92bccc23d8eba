"""ctypes bindings for the native runtime library (`native/`; a copy of
`aclswarm_tpu/interop/native.py` loading the same C library).

Loads ``native/build/libaclswarm_native.so`` (built by ``make -C native``;
g++ only, no pybind11). Exposes the C-ABI codec and shm-ring symbols with
typed signatures; ``available()`` gates callers so everything degrades to
the pure-Python implementations when the library isn't built — the wire
format is identical either way (`aclswarm_torch.interop.codec` is the
reference implementation, byte-parity is tested).
"""
from __future__ import annotations

import ctypes as C
from pathlib import Path
from typing import Optional

_LIB_PATH = (Path(__file__).resolve().parents[2] / "native" / "build"
             / "libaclswarm_native.so")
_lib: Optional[C.CDLL] = None
_load_failed = False


def _sig(fn, res, args):
    fn.restype = res
    fn.argtypes = args
    return fn


def load() -> Optional[C.CDLL]:
    """Load (once) and type the native library; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists():
        _load_failed = True
        return None
    try:
        lib = C.CDLL(str(_LIB_PATH))
        return _register(lib)
    except OSError:
        _load_failed = True
        return None
    except AttributeError:
        # a stale prebuilt library missing newer symbols: treat as
        # unavailable (callers degrade to the byte-identical Python
        # codec; `build()` clears the flag after a `make -C native`)
        _load_failed = True
        return None


def _register(lib: C.CDLL) -> C.CDLL:
    global _lib
    u8p = C.POINTER(C.c_uint8)
    u32p = C.POINTER(C.c_uint32)
    u64p = C.POINTER(C.c_uint64)
    f32p = C.POINTER(C.c_float)
    f64p = C.POINTER(C.c_double)
    i32p = C.POINTER(C.c_int32)
    intp = C.POINTER(C.c_int)
    _sig(lib.asw_crc32, C.c_uint32, [u8p, C.c_uint64])
    _sig(lib.asw_parse_frame, C.c_int, [u8p, C.c_uint64, u64p, u64p])
    _sig(lib.asw_encode_formation, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_char_p, C.c_uint32,
          f64p, u8p, f32p, u8p, C.c_uint64])
    _sig(lib.asw_formation_dims, C.c_int, [u8p, C.c_uint64, u32p, intp])
    _sig(lib.asw_decode_formation, C.c_int,
         [u8p, C.c_uint64, u32p, C.POINTER(C.c_double), C.c_char_p,
          C.c_uint64, C.c_char_p, C.c_uint64, f64p, u8p, f32p])
    _sig(lib.asw_encode_cbaa, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_uint32, C.c_uint32,
          C.c_uint32, f32p, i32p, u8p, C.c_uint64])
    _sig(lib.asw_cbaa_n, C.c_int, [u8p, C.c_uint64, u32p])
    _sig(lib.asw_decode_cbaa, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, u32p, u32p, f32p, i32p])
    _sig(lib.asw_encode_estimates, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_uint32, f64p, f64p, u8p,
          C.c_uint64])
    _sig(lib.asw_estimates_n, C.c_int, [u8p, C.c_uint64, u32p])
    _sig(lib.asw_decode_estimates, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, f64p, f64p])
    _sig(lib.asw_encode_status, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_int, u8p, C.c_uint64])
    _sig(lib.asw_decode_status, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, intp])
    _sig(lib.asw_encode_distcmd, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_uint32, f64p, u8p,
          C.c_uint64])
    _sig(lib.asw_distcmd_n, C.c_int, [u8p, C.c_uint64, u32p])
    _sig(lib.asw_decode_distcmd, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, f64p])
    _sig(lib.asw_encode_assignment, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_uint32, i32p, u8p,
          C.c_uint64])
    _sig(lib.asw_assignment_n, C.c_int, [u8p, C.c_uint64, u32p])
    _sig(lib.asw_decode_assignment, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, i32p])
    _sig(lib.asw_encode_flightmode, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_int, u8p, C.c_uint64])
    _sig(lib.asw_decode_flightmode, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, intp])
    _sig(lib.asw_encode_safety_array, C.c_int64,
         [C.c_uint32, C.c_double, C.c_char_p, C.c_uint32, u8p, u8p,
          C.c_uint64])
    _sig(lib.asw_safety_array_n, C.c_int, [u8p, C.c_uint64, u32p])
    _sig(lib.asw_decode_safety_array, C.c_int,
         [u8p, C.c_uint64, u32p, f64p, u8p])
    _sig(lib.asw_ring_open, C.c_void_p, [C.c_char_p, C.c_uint32, C.c_int])
    _sig(lib.asw_ring_close, None, [C.c_void_p, C.c_int])
    _sig(lib.asw_ring_write, C.c_int, [C.c_void_p, u8p, C.c_uint32])
    _sig(lib.asw_ring_read, C.c_int64, [C.c_void_p, u8p, C.c_uint32])
    _sig(lib.asw_ring_used, C.c_uint64, [C.c_void_p])
    _sig(lib.asw_ring_capacity, C.c_uint32, [C.c_void_p])
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def build(quiet: bool = True) -> bool:
    """Try to build the library (used by tests); returns availability."""
    global _load_failed
    if available():
        return True
    import subprocess
    root = _LIB_PATH.parents[2]
    try:
        subprocess.run(["make", "-C", str(root / "native")],
                       capture_output=quiet, check=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    _load_failed = False
    return available()


def build_locked(quiet: bool = True) -> bool:
    """`build` under a file lock beside the library: processes that share
    the build directory (parallel test workers) build it once, and none
    loads it while another is still writing it."""
    import fcntl
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(_LIB_PATH.parent / ".build.lock", "a+b") as f:
        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
        return build(quiet)
