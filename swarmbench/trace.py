"""The reading of a traced run: what the per-layer readers take their
numbers from.

Two chunks of the window are profiled (`harness.run_window`): one with
the card's activity alone, which gives the device's busy time, the copies
to the host and each kernel's time; and one with the host's spans beside
it, which attributes each kernel to the spans it was launched in (by the
runtime call that launched it) and each idle gap of the device to the
span the host was in when the gap began.
"""
from __future__ import annotations

import bisect
import dataclasses

from swarmbench import harness


@dataclasses.dataclass
class Reading:
    batch: int
    n: int
    ticks: int                 # batched ticks in each profiled chunk
    window_s: float            # the device-only chunk's length
    busy_s: float
    d2h: int                   # device-to-host copies in it
    kernel_s: dict             # kernel name -> seconds in it
    kernel_n: dict             # kernel name -> launches in it
    kernel_calls: list         # (K1|K2|K3, shapes) of its kernel calls
    span_device_s: dict        # span -> device seconds (outermost)
    span_calls: dict           # span -> outermost calls
    host_step_ms: float | None  # host ms in engine.step per batched tick
    peak_bytes: int
    idle_by_span: dict         # span -> device idle seconds it began in
    telemetry: dict | None     # the device counters after the window
    adjacency_nnz: list        # per trial, edges of its formation graph
    cfg: dict


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def _cuda(dev: str) -> bool:
    return dev.endswith("CUDA")


def union_s(intervals: list) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e9


def outermost(intervals: list) -> list:
    """Intervals not inside another of the list, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s >= out[-1][0] and e <= out[-1][1]:
            continue
        out.append((s, e))
    return out


def device_part(box: dict) -> dict:
    ks, kn, iv, d2h = {}, {}, [], 0
    for name, dev, start, dur, _, _, annot in box["events"]:
        if not _cuda(dev) or annot:
            continue
        if "Memcpy DtoH" in name:
            d2h += 1
        if _is_kernel(name):
            ks[name] = ks.get(name, 0.0) + dur / 1e9
            kn[name] = kn.get(name, 0) + 1
            iv.append((start, start + dur))
    if not iv:
        raise RuntimeError("the profiler recorded no kernel in its window")
    return {"kernel_s": ks, "kernel_n": kn, "busy_s": union_s(iv),
            "d2h": d2h}


def span_part(box: dict) -> dict:
    spans: dict = {}
    launches: dict = {}
    kernels = []
    for name, dev, start, dur, corr, linked, annot in box["events"]:
        if _cuda(dev):
            # the device side also mirrors each host span: not a kernel
            if not annot and _is_kernel(name):
                kernels.append((start, dur, corr, linked))
        elif annot and name in harness.SPANS:
            spans.setdefault(name, []).append((start, start + dur))
        elif name.startswith("cu"):
            launches[corr] = start
    if not kernels:
        raise RuntimeError("the profiler recorded no kernel in the spans "
                           "window")
    outer = {k: outermost(v) for k, v in spans.items()}
    starts = {k: [s for s, _ in v] for k, v in outer.items()}
    dev_s = dict.fromkeys(outer, 0.0)
    for start, dur, corr, linked in kernels:
        t = launches.get(corr, launches.get(linked, start))
        for k, iv in outer.items():
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1]:
                dev_s[k] += dur / 1e9
    # idle gaps of the device, by the innermost span the host was in
    busy = sorted((s, s + d) for s, d, *_ in kernels)
    idle: dict = {}
    end = None
    for s, e in busy:
        if end is not None and s > end:
            inner, latest = "host outside the spans", None
            for k, iv in outer.items():
                i = bisect.bisect_right(starts[k], end) - 1
                if i >= 0 and iv[i][1] >= end and (
                        latest is None or iv[i][0] > latest):
                    inner, latest = k, iv[i][0]
            idle[inner] = idle.get(inner, 0.0) + (s - end) / 1e9
        end = e if end is None else max(end, e)
    return {"span_device_s": dev_s,
            "span_calls": {k: len(v) for k, v in outer.items()},
            "idle_by_span": idle}


def reading(S, w, spans, telemetry=None) -> Reading:
    dev = device_part(w.trace["device"])
    sp = span_part(w.trace["spans"])
    T = int(S.traffic["chunk"])
    host = (spans.step_s * 1e3 / spans.steps) if spans.steps else None
    return Reading(
        batch=int(S.traffic["batch"]), n=int(S.cfg["n"]), ticks=T,
        window_s=w.trace["device"]["host_s"],
        busy_s=dev["busy_s"], d2h=dev["d2h"], kernel_s=dev["kernel_s"],
        kernel_n=dev["kernel_n"], kernel_calls=list(spans.kernel_calls),
        span_device_s=sp["span_device_s"], span_calls=sp["span_calls"],
        host_step_ms=host, peak_bytes=w.peak_bytes,
        idle_by_span=sp["idle_by_span"], telemetry=telemetry,
        adjacency_nnz=[int((t["adj"] != 0).sum()) for t in S.trials],
        cfg=S.cfg)


def breakdown(r: Reading) -> dict:
    ops = sorted(r.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(r.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
