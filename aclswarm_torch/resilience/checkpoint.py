"""Chunk-boundary checkpoint codec (port of
`aclswarm_tpu/resilience/checkpoint.py`): deterministic resume for trials.

The trial driver writes one file at a chunk boundary, and a resumed run
continues bit for bit from where the dead one stopped. Frame layout
(little-endian; no pickle, no third-party dependency):

    u32  magic   = 0x4B435341  ("ASCK" in LE byte order)
    u8   version = FORMAT_VERSION
    u8   reserved, u16 reserved
    u32  meta_len
    u32  n_arrays
    u32  crc32(everything after this field)
    meta JSON bytes                  {"manifest": {...}, "payload": spec}
    per array: u16 dtype_len, dtype str, u8 ndim, u64 shape[ndim],
               u64 nbytes, raw little-endian bytes

The *payload* nests dicts (str keys), lists, scalars (int, float, bool,
str, None) and numpy arrays; arrays are replaced in the JSON spec by
``{"__array__": index}`` references into the array table. JSON floats and
raw array bytes round-trip exactly.

The *manifest* carries what makes a checkpoint wrong to resume from: the
producing run's config hash, the dtype-and-device fingerprint, the code
and format versions, a ``kind`` tag and the chunk. `load_checkpoint`
validates an expected subset and raises `CheckpointMismatch`; truncated or
corrupted files raise `CheckpointCorrupt`. Writes are atomic (tmp +
`os.replace`) with bounded retention.

Two more shapes of the same frames serve the serving layer
(`aclswarm_torch.serve`): `append_frame` / `read_frame_log` keep an
append-only log of frames whose torn trailing record (a crash mid-append)
reads as a clean end, and `tree_arrays` / `restore_tree` carry any
container of tensors (a serve request's `SimState` row) as a flat list of
arrays, restored onto a template's device and dtypes.

`SimState` crosses as `convert.sim_state_to_numpy`'s nested dict and
comes back through `restore_state`, every leaf checked against the
resuming run's own state (`check_leaves`; ``batch_flex`` lets a batched
wave resume across a compaction of its trial axis). A fault schedule and
a scenario ride the state as leaves, so a resumed faulted or scenario run
redraws each tick's links, lies, gusts and noise from the same keys and
ticks, bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

MAGIC = 0x4B435341                   # "ASCK" little-endian
FORMAT_VERSION = 1
_HDR = struct.Struct("<IBBHIII")     # magic, ver, r8, r16, meta, narr, crc
SUFFIX = ".ckpt"


class CheckpointError(RuntimeError):
    """Base class: anything wrong with reading or validating a
    checkpoint."""


class CheckpointCorrupt(CheckpointError):
    """Truncated, garbled, or CRC-failing checkpoint file."""

    def __init__(self, path, detail: str):
        self.path = str(path)
        self.detail = detail
        super().__init__(f"corrupt checkpoint {path}: {detail}")


class CheckpointMismatch(CheckpointError):
    """Structurally valid checkpoint that must NOT be resumed from: the
    manifest (or a restored leaf) contradicts the resuming run.
    ``mismatches`` lists (field, expected, found) triples."""

    def __init__(self, path, mismatches: list):
        self.path = str(path)
        self.mismatches = list(mismatches)
        lines = "; ".join(f"{f}: expected {e!r}, found {g!r}"
                          for f, e, g in self.mismatches)
        super().__init__(
            f"checkpoint {path} rejected ({lines}) — delete it or rerun "
            "with the producing configuration; resuming would silently "
            "compute wrong results")


# ---------------------------------------------------------------------------
# payload spec <-> arrays

def _encode(obj, arrays: list) -> Any:
    if isinstance(obj, np.ndarray):
        # asarray(order="C"), not ascontiguousarray: the latter turns a
        # 0-d array into a 1-d one
        arrays.append(np.asarray(obj, order="C"))
        return {"__array__": len(arrays) - 1}
    if isinstance(obj, np.generic):          # numpy scalar -> 0-d array
        return _encode(np.asarray(obj), arrays)
    if isinstance(obj, dict):
        if any(not isinstance(k, str) for k in obj):
            raise TypeError("checkpoint payload dict keys must be str")
        if "__array__" in obj:
            raise TypeError("'__array__' is a reserved payload key")
        return {k: _encode(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v, arrays) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"unsupported checkpoint payload type {type(obj)!r}")


def _decode(spec, arrays: list) -> Any:
    if isinstance(spec, dict):
        if set(spec) == {"__array__"}:
            return arrays[spec["__array__"]]
        return {k: _decode(v, arrays) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_decode(v, arrays) for v in spec]
    return spec


# ---------------------------------------------------------------------------
# frame codec

def zlib_crc(b: bytes) -> int:
    """The frame's body checksum: CRC-32 as an unsigned 32-bit int."""
    return zlib.crc32(b) & 0xFFFFFFFF


def dumps(payload, manifest: dict) -> bytes:
    """Serialize one checkpoint frame (see the module docstring)."""
    arrays: list = []
    spec = _encode(payload, arrays)
    meta = json.dumps({"manifest": manifest, "payload": spec},
                      sort_keys=True).encode()
    parts = [meta]
    for a in arrays:
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        parts.append(struct.pack("<H", len(a.dtype.str))
                     + a.dtype.str.encode()
                     + struct.pack("<B", a.ndim)
                     + struct.pack(f"<{a.ndim}Q", *a.shape)
                     + struct.pack("<Q", len(raw)) + raw)
    body = b"".join(parts)
    return _HDR.pack(MAGIC, FORMAT_VERSION, 0, 0, len(meta), len(arrays),
                     zlib_crc(body)) + body


def loads(buf: bytes, path="<bytes>") -> tuple[Any, dict]:
    """Parse one frame; returns (payload, manifest). Raises
    `CheckpointCorrupt` on any structural damage."""
    if len(buf) < _HDR.size:
        raise CheckpointCorrupt(path, "short header")
    magic, ver, r8, r16, meta_len, n_arrays, crc = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise CheckpointCorrupt(path, f"bad magic 0x{magic:08X}")
    if r8 != 0 or r16 != 0:
        # the reserved bytes sit outside the body CRC
        raise CheckpointCorrupt(
            path, f"nonzero reserved header bytes (r8={r8}, r16={r16})"
                  " — header bit rot")
    if ver != FORMAT_VERSION:
        raise CheckpointMismatch(
            path, [("format_version", FORMAT_VERSION, ver)])
    body = buf[_HDR.size:]
    if zlib_crc(body) != crc:
        raise CheckpointCorrupt(path, "crc mismatch (truncated or "
                                "bit-rotted body)")
    if meta_len > len(body):
        raise CheckpointCorrupt(
            path, f"meta length {meta_len} exceeds body ({len(body)}) "
                  "— header bit rot")
    try:
        meta = json.loads(body[:meta_len].decode())
        off = meta_len
        arrays = []
        for _ in range(n_arrays):
            (dlen,) = struct.unpack_from("<H", body, off)
            off += 2
            dtype = np.dtype(body[off:off + dlen].decode())
            off += dlen
            (ndim,) = struct.unpack_from("<B", body, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}Q", body, off)
            off += 8 * ndim
            (nbytes,) = struct.unpack_from("<Q", body, off)
            off += 8
            raw = body[off:off + nbytes]
            if len(raw) != nbytes:
                raise ValueError("array data truncated")
            off += nbytes
            arrays.append(np.frombuffer(raw, dtype.newbyteorder("<"))
                          .reshape(shape).astype(dtype, copy=False))
        if off != len(body):
            raise ValueError(f"{len(body) - off} trailing byte(s) "
                             "after the array table")
    except (ValueError, KeyError, IndexError, struct.error,
            UnicodeDecodeError) as e:
        raise CheckpointCorrupt(path, f"unparseable body ({e})") from e
    try:
        return _decode(meta["payload"], arrays), meta["manifest"]
    except (KeyError, IndexError, TypeError) as e:
        raise CheckpointCorrupt(path, f"unparseable payload ({e})") from e


# ---------------------------------------------------------------------------
# append-only frame log (torn-tail tolerant)

_LOG_LEN = struct.Struct("<I")      # per-record length prefix


def append_frame(path, payload, manifest: dict, fh=None) -> None:
    """Append one length-prefixed frame to an append-only log. Not atomic:
    a crash mid-append leaves a torn trailing record, which
    `read_frame_log` reads as a clean end. ``fh`` (an append-mode binary
    file object) spares a high-rate writer the open and close per record;
    the record is flushed to the OS before returning either way."""
    frame = dumps(payload, manifest)
    record = _LOG_LEN.pack(len(frame)) + frame
    if fh is not None:
        fh.write(record)
        fh.flush()
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "ab") as f:
        f.write(record)


def read_frame_log(path) -> tuple[list, bool]:
    """Every frame of an append-only log: ``(frames, torn_tail)``, frames
    a list of ``(payload, manifest)``. A truncated or CRC-failing trailing
    record is dropped and reported as ``torn_tail=True``; a corrupt record
    with more data after it cannot be a torn append and raises
    `CheckpointCorrupt`."""
    path = Path(path)
    try:
        buf = path.read_bytes()
    except OSError as e:
        raise CheckpointCorrupt(path, f"unreadable ({e})") from e
    frames: list = []
    off, n = 0, len(buf)
    while off < n:
        if n - off < _LOG_LEN.size:
            return frames, True          # torn length prefix at the tail
        (flen,) = _LOG_LEN.unpack_from(buf, off)
        start = off + _LOG_LEN.size
        end = start + flen
        if end > n:
            return frames, True          # truncated trailing frame
        try:
            frames.append(loads(buf[start:end], f"{path}@{off}"))
        except CheckpointError as e:
            if end == n:
                return frames, True      # CRC-failing trailing frame
            raise CheckpointCorrupt(
                path, f"corrupt non-trailing record at offset {off} "
                      f"({getattr(e, 'detail', e)}) with "
                      f"{n - end} byte(s) after it — not a torn append"
            ) from e
        off = end
    return frames, False


# ---------------------------------------------------------------------------
# manifest helpers

def code_version() -> str:
    import aclswarm_torch
    return aclswarm_torch.__version__


def dtype_fingerprint(dtype: torch.dtype, device) -> str:
    """The precision and device the producing run computed in: a float32
    card run and a float64 CPU run give other numbers, so one must not
    resume the other."""
    return (f"torch={str(dtype).removeprefix('torch.')},"
            f"device={torch.device(device).type}")


def config_hash(cfg_dict: dict) -> str:
    """Canonical-JSON SHA-256 of a configuration dict (callers drop the
    fields that cannot change results)."""
    blob = json.dumps(cfg_dict, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()


def make_manifest(kind: str, cfg_hash: str, chunk: int, fingerprint: str,
                  **extra) -> dict:
    m = {"kind": kind, "config_hash": cfg_hash, "chunk": int(chunk),
         "format_version": FORMAT_VERSION, "code_version": code_version(),
         "dtype": fingerprint}
    m.update(extra)
    return m


def check_manifest(path, found: dict, expected: dict) -> None:
    """Raise `CheckpointMismatch` listing every expected field the found
    manifest contradicts (missing counts as contradicting)."""
    bad = [(k, v, found.get(k)) for k, v in expected.items()
           if found.get(k) != v]
    if bad:
        raise CheckpointMismatch(path, bad)


def expected_manifest(kind: str, cfg_hash: str, fingerprint: str,
                      **extra) -> dict:
    """The subset a resuming driver insists on (progress fields like
    ``chunk`` are read, not matched)."""
    e = {"kind": kind, "config_hash": cfg_hash,
         "format_version": FORMAT_VERSION, "code_version": code_version(),
         "dtype": fingerprint}
    e.update(extra)
    return e


# ---------------------------------------------------------------------------
# SimState <-> arrays (template-validated restore)

def _leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def check_leaves(want: dict, got: dict, *, batch_flex: bool = False,
                 path="<arrays>", what: str = "SimState") -> None:
    """Raise `CheckpointMismatch` unless the checkpointed leaves ``got``
    match the template's ``want`` (both nested dicts of arrays) in
    presence, dtype and shape. ``batch_flex`` relaxes axis 0 only: the
    batched trial driver's compaction shrinks the trial axis."""
    want, got = _leaves(want), _leaves(got)
    bad = [(f"{what}.{k}", "present" if k in want else "absent",
            "present" if k in got else "absent")
           for k in sorted(set(want) ^ set(got))]
    for k in sorted(set(want) & set(got)):
        t, a = np.asarray(want[k]), np.asarray(got[k])
        if t.dtype != a.dtype:
            bad.append((f"{what}.{k}.dtype", str(t.dtype), str(a.dtype)))
        elif t.shape != a.shape and not (
                batch_flex and t.ndim == a.ndim >= 1
                and t.shape[1:] == a.shape[1:]):
            bad.append((f"{what}.{k}.shape", t.shape, a.shape))
    if bad:
        raise CheckpointMismatch(path, bad)


def restore_state(template, arrays: dict, *, batch_flex: bool = False,
                  path="<arrays>"):
    """A `SimState` on ``template``'s device and in its dtype, from
    checkpointed leaves (`convert.sim_state_to_numpy`'s nested dict). Every
    leaf must match the template's in presence, dtype and shape: a leaf
    that no longer lines up means the checkpoint predates a structural
    change (`CheckpointMismatch`). ``batch_flex``: a batched state whose
    trial axis may have shrunk (a compacted wave)."""
    from aclswarm_torch import convert

    check_leaves(convert.sim_state_to_numpy(template), arrays,
                 batch_flex=batch_flex, path=path)
    return convert.sim_state_from_numpy(arrays, device=template.swarm.q.device,
                                        dtype=template.swarm.q.dtype)


# ---------------------------------------------------------------------------
# container leaves <-> arrays (template-validated restore)

def _flatten(tree, out: list) -> list:
    """Leaves of a container tree in a fixed order: dataclass fields and
    tuple items in order, dict values by key; tensors, numpy arrays and
    host scalars are leaves, None drops out."""
    if tree is None:
        return out
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic, bool, int,
                         float)):
        out.append(tree)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flatten(getattr(tree, f.name), out)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _flatten(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        raise TypeError(f"unsupported container leaf {type(tree)!r}")
    return out


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (bool, int)):
        return np.asarray(x, np.bool_ if isinstance(x, bool) else np.int64)
    return np.asarray(x)


def tree_arrays(tree) -> list:
    """Host copies of a container's leaves (tensors, numpy arrays and host
    scalars such as a state's tick), in `restore_tree`'s order."""
    return [_host_array(x) for x in _flatten(tree, [])]


def _rebuild(template, it):
    from aclswarm_torch.scenarios import timeline as scenlib

    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.array(next(it))).to(template.device)
    if isinstance(template, bool):
        return bool(next(it))
    if isinstance(template, int):
        return int(next(it))
    if isinstance(template, float):
        return float(next(it))
    if isinstance(template, (np.ndarray, np.generic)):
        return np.array(next(it))
    if dataclasses.is_dataclass(template):
        if isinstance(template, scenlib.Scenario):
            names = [f.name for f in dataclasses.fields(template)]
            leaves = [next(it) for _ in names]
            out = scenlib.Scenario(**{
                k: torch.from_numpy(np.array(a)).to(
                    getattr(template, k).device)
                for k, a in zip(names, leaves)})
            return scenlib.attach_host(out, dict(zip(names, leaves)))
        return type(template)(**{
            f.name: _rebuild(getattr(template, f.name), it)
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(x, it) for x in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(x, it) for x in template)
    if isinstance(template, dict):
        return {k: _rebuild(template[k], it) for k in sorted(template)}
    raise TypeError(f"unsupported container leaf {type(template)!r}")


def restore_tree(template, arrays: list, *, batch_flex: bool = False,
                 path="<arrays>", what: str = "tree"):
    """``template``'s container rebuilt from `tree_arrays`'s list, every
    tensor on the template's device, every leaf checked against the
    template's dtype and shape (``batch_flex`` relaxes axis 0 only). A
    leaf that no longer lines up means the arrays predate a structural
    change: `CheckpointMismatch`. Restored values equal the saved ones bit
    for bit."""
    want = tree_arrays(template)
    if len(arrays) != len(want):
        raise CheckpointMismatch(
            path, [(f"{what}.n_leaves", len(want), len(arrays))])
    bad = []
    for i, (t, a) in enumerate(zip(want, arrays)):
        a = np.asarray(a)
        if t.dtype != a.dtype:
            bad.append((f"{what}[{i}].dtype", str(t.dtype), str(a.dtype)))
        elif t.shape != a.shape and not (
                batch_flex and t.ndim == a.ndim >= 1
                and t.shape[1:] == a.shape[1:]):
            bad.append((f"{what}[{i}].shape", t.shape, a.shape))
    if bad:
        raise CheckpointMismatch(path, bad)
    return _rebuild(template, iter(arrays))


# ---------------------------------------------------------------------------
# files: atomic write, bounded retention, latest lookup

def _ckpt_name(stem: str, chunk: int) -> str:
    return f"{stem}.c{chunk:08d}{SUFFIX}"


def write_checkpoint(directory, stem: str, payload, manifest: dict,
                     keep: int = 2) -> Path:
    """Atomically write ``{stem}.c{chunk:08d}.ckpt`` under ``directory``
    (tmp + rename, same filesystem) and prune all but the newest ``keep``
    checkpoints of the same stem."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / _ckpt_name(stem, int(manifest["chunk"]))
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(dumps(payload, manifest))
    os.replace(tmp, path)
    if keep > 0:
        for p in sorted(directory.glob(f"{stem}.c*{SUFFIX}"))[:-keep]:
            p.unlink(missing_ok=True)
    return path


def latest_checkpoint(directory, stem: str) -> Optional[Path]:
    """Newest checkpoint of ``stem`` (by chunk index in the name), or
    None. A corrupt newest file is the loader's loud failure: this lookup
    never falls back to an older file."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    found = sorted(directory.glob(f"{stem}.c*{SUFFIX}"))
    return found[-1] if found else None


def load_checkpoint(path, expected: Optional[dict] = None
                    ) -> tuple[Any, dict]:
    """Read and validate one checkpoint file; returns (payload,
    manifest). Raises `CheckpointCorrupt` / `CheckpointMismatch`."""
    path = Path(path)
    try:
        buf = path.read_bytes()
    except OSError as e:
        raise CheckpointCorrupt(path, f"unreadable ({e})") from e
    payload, manifest = loads(buf, path)
    if expected is not None:
        check_manifest(path, manifest, expected)
    return payload, manifest


def clear_checkpoints(directory, stem: str) -> int:
    """Delete every checkpoint of ``stem``; returns the count removed."""
    directory = Path(directory)
    if not directory.is_dir():
        return 0
    n = 0
    for p in directory.glob(f"{stem}.c*{SUFFIX}"):
        p.unlink(missing_ok=True)
        n += 1
    return n
