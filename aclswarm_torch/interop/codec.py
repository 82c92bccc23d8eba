"""Framed binary codec for the wire-API messages — Python implementation
(a copy of `aclswarm_tpu/interop/codec.py`; the same message encodes to
the same bytes in both packages).

Frame layout (little-endian), shared with the native C++ codec
(`native/codec.cpp`, byte-identical by test):

    u32  magic   = 0x4D575341  ("ASWM" in LE byte order)
    u8   version = 1
    u8   type    (messages.MSG_*)
    u16  reserved = 0
    u32  payload_len
    u32  crc32(payload)   (zlib/IEEE polynomial)
    payload...

Payload layouts (all little-endian, no padding):

    Header       := u32 seq, f64 stamp, u16 len, bytes frame_id
    Formation    := Header, u16 len, bytes name, u32 n,
                    f64 points[n*3], u8 adjmat[n*n],
                    u8 has_gains, [f32 gains[9*n*n]]
    CBAA         := Header, u32 auction_id, u32 iter, u32 n,
                    f32 price[n], i32 who[n]
    VehicleEst.  := Header, u32 n, (f64 stamp, f64 x, f64 y, f64 z)[n]
    SafetyStatus := Header, u8 active
    DistCmd      := Header, u32 n, f64 vel[n*3]
    Assignment   := Header, u32 n, i32 perm[n]
    FlightMode   := Header, u8 mode
    SafetyArray  := Header, u32 n, u8 active[n]

The format exists so non-Python processes (the reference's C++ nodes, a
ROS bridge) can exchange planner traffic with zero dependencies — it is
the `aclswarm_msgs` boundary as bytes. The reference's transport for these
messages is TCPROS; here the framing is transport-agnostic (works over the
shm ring in `aclswarm_torch.interop.transport`, a socket, or a file).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from aclswarm_torch.interop import messages as m

MAGIC = 0x4D575341
VERSION = 1
_HDR = struct.Struct("<IBBHII")   # magic, version, type, reserved, len, crc


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ValueError("string too long for wire format")
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf: memoryview, off: int) -> tuple[str, int]:
    (ln,) = struct.unpack_from("<H", buf, off)
    off += 2
    if off + ln > len(buf):
        # bounds-check like the native Reader::str — a malformed length
        # must raise, not silently truncate and misparse later fields
        raise ValueError("string length exceeds payload")
    return bytes(buf[off:off + ln]).decode("utf-8"), off + ln


def _pack_header(h: m.Header) -> bytes:
    return struct.pack("<Id", h.seq, h.stamp) + _pack_str(h.frame_id)


def _unpack_header(buf: memoryview, off: int) -> tuple[m.Header, int]:
    seq, stamp = struct.unpack_from("<Id", buf, off)
    off += 12
    frame, off = _unpack_str(buf, off)
    return m.Header(seq=seq, stamp=stamp, frame_id=frame), off


def _payload(msg) -> tuple[int, bytes]:
    if isinstance(msg, m.Formation):
        n = msg.n
        out = [_pack_header(msg.header), _pack_str(msg.name),
               struct.pack("<I", n),
               np.ascontiguousarray(msg.points, "<f8").tobytes(),
               np.ascontiguousarray(msg.adjmat, np.uint8).tobytes()]
        if msg.gains is None:
            out.append(b"\x00")
        else:
            g = np.ascontiguousarray(msg.gains, "<f4")
            if g.shape != (3 * n, 3 * n):
                raise ValueError(f"gains shape {g.shape} != {(3*n, 3*n)}")
            out.append(b"\x01" + g.tobytes())
        return m.MSG_FORMATION, b"".join(out)
    if isinstance(msg, m.CBAA):
        n = msg.price.shape[0]
        return m.MSG_CBAA, b"".join([
            _pack_header(msg.header),
            struct.pack("<III", msg.auction_id, msg.iter, n),
            np.ascontiguousarray(msg.price, "<f4").tobytes(),
            np.ascontiguousarray(msg.who, "<i4").tobytes()])
    if isinstance(msg, m.VehicleEstimates):
        n = msg.positions.shape[0]
        inter = np.empty((n, 4), "<f8")
        inter[:, 0] = msg.stamps
        inter[:, 1:] = msg.positions
        return m.MSG_VEHICLE_ESTIMATES, b"".join([
            _pack_header(msg.header), struct.pack("<I", n),
            inter.tobytes()])
    if isinstance(msg, m.SafetyStatus):
        return m.MSG_SAFETY_STATUS, (
            _pack_header(msg.header)
            + struct.pack("<B", int(msg.collision_avoidance_active)))
    if isinstance(msg, m.DistCmd):
        n = msg.vel.shape[0]
        return m.MSG_DIST_CMD, b"".join([
            _pack_header(msg.header), struct.pack("<I", n),
            np.ascontiguousarray(msg.vel, "<f8").tobytes()])
    if isinstance(msg, m.Assignment):
        n = msg.perm.shape[0]
        return m.MSG_ASSIGNMENT, b"".join([
            _pack_header(msg.header), struct.pack("<I", n),
            np.ascontiguousarray(msg.perm, "<i4").tobytes()])
    if isinstance(msg, m.FlightMode):
        return m.MSG_FLIGHT_MODE, (
            _pack_header(msg.header) + struct.pack("<B", int(msg.mode)))
    if isinstance(msg, m.SafetyStatusArray):
        n = msg.active.shape[0]
        return m.MSG_SAFETY_ARRAY, b"".join([
            _pack_header(msg.header), struct.pack("<I", n),
            np.ascontiguousarray(msg.active, np.uint8).tobytes()])
    raise TypeError(f"not a wire message: {type(msg)!r}")


def encode(msg) -> bytes:
    """Serialize a message dataclass into one framed byte string."""
    mtype, payload = _payload(msg)
    return _HDR.pack(MAGIC, VERSION, mtype, 0, len(payload),
                     zlib.crc32(payload) & 0xFFFFFFFF) + payload


def decode(buf: bytes):
    """Parse one framed message; raises ValueError on corruption."""
    view = memoryview(buf)
    if len(view) < _HDR.size:
        raise ValueError("short frame")
    magic, version, mtype, _, plen, crc = _HDR.unpack_from(view, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:08X}")
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    payload = view[_HDR.size:_HDR.size + plen]
    if len(payload) != plen:
        raise ValueError("truncated payload")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise ValueError("crc mismatch")
    off = 0
    header, off = _unpack_header(payload, off)
    if mtype == m.MSG_FORMATION:
        name, off = _unpack_str(payload, off)
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        pts = np.frombuffer(payload, "<f8", n * 3, off).reshape(n, 3).copy()
        off += n * 3 * 8
        adj = np.frombuffer(payload, np.uint8, n * n, off).reshape(n, n).copy()
        off += n * n
        (has_gains,) = struct.unpack_from("<B", payload, off)
        off += 1
        gains = None
        if has_gains:
            gains = np.frombuffer(payload, "<f4", 9 * n * n,
                                  off).reshape(3 * n, 3 * n).copy()
        return m.Formation(header=header, name=name, points=pts, adjmat=adj,
                           gains=gains)
    if mtype == m.MSG_CBAA:
        aid, it, n = struct.unpack_from("<III", payload, off)
        off += 12
        price = np.frombuffer(payload, "<f4", n, off).copy()
        off += 4 * n
        who = np.frombuffer(payload, "<i4", n, off).copy()
        return m.CBAA(header=header, auction_id=aid, iter=it, price=price,
                      who=who)
    if mtype == m.MSG_VEHICLE_ESTIMATES:
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        inter = np.frombuffer(payload, "<f8", n * 4, off).reshape(n, 4)
        return m.VehicleEstimates(header=header,
                                  positions=inter[:, 1:].copy(),
                                  stamps=inter[:, 0].copy())
    if mtype == m.MSG_SAFETY_STATUS:
        (active,) = struct.unpack_from("<B", payload, off)
        return m.SafetyStatus(header=header,
                              collision_avoidance_active=bool(active))
    if mtype == m.MSG_DIST_CMD:
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        vel = np.frombuffer(payload, "<f8", n * 3, off).reshape(n, 3).copy()
        return m.DistCmd(header=header, vel=vel)
    if mtype == m.MSG_ASSIGNMENT:
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        perm = np.frombuffer(payload, "<i4", n, off).copy()
        return m.Assignment(header=header, perm=perm)
    if mtype == m.MSG_FLIGHT_MODE:
        (mode,) = struct.unpack_from("<B", payload, off)
        return m.FlightMode(header=header, mode=int(mode))
    if mtype == m.MSG_SAFETY_ARRAY:
        (n,) = struct.unpack_from("<I", payload, off)
        off += 4
        active = np.frombuffer(payload, np.uint8, n, off).copy()
        return m.SafetyStatusArray(header=header, active=active)
    raise ValueError(f"unknown message type {mtype}")
