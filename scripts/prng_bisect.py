"""Bisect the port's float32 normal draw, card against CPU.

    python3 scripts/prng_bisect.py [--seed S] [--n N]

Draws the `sensor_noise` family's estimate noise key of
`chip_smoke.py`'s `slice_scenarios` phase (family index in registry
order, seed S + index, tick 120: n*n*3 normal draws) and runs
`core.prng.normal`'s float32 chain step by step on the card and on the
CPU. For every intermediate it prints one JSON line: how many elements
of the card's chain differ from the CPU's chain (``chain_differ``), and
how many differ when the card runs only that step on the CPU's own
inputs (``alone_differ``): the first step with ``alone_differ > 0`` is
the operation that rounds otherwise on the card. ``sqrt_w_f32`` is the
float32 `torch.sqrt` the chain took before (NVIDIA H100: 19880 of
3*10^6 roots differ); the chain now takes the float64 root rounded once
(``sqrt_w``), and the last line counts `prng.normal`'s draws that still
differ. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from aclswarm_torch import scenarios  # noqa: E402
from aclswarm_torch.core import prng  # noqa: E402
from aclswarm_torch.scenarios import timeline  # noqa: E402

F32 = torch.float32


def _horner_steps(name, coefs, arg):
    """`prng._horner`'s float32 steps: p = fl32(fl64(p) * fl64(w) + c)."""
    steps = [(f"{name}.w64", lambda e, a=arg: e[a].double(), (arg,)),
             (f"{name}.p0", lambda e, a=arg, c=coefs[0]: torch.full_like(
                 e[a], prng.rounded(c, F32)), (arg,))]
    prev = f"{name}.p0"
    for i, c in enumerate(coefs[1:], 1):
        steps.append((f"{name}.mul{i}", lambda e, p=prev:
                      e[p].double() * e[f"{name}.w64"],
                      (prev, f"{name}.w64")))
        steps.append((f"{name}.add{i}", lambda e, i=i, c=c:
                      (e[f"{name}.mul{i}"] + prng.rounded(c, F32)).float(),
                      (f"{name}.mul{i}",)))
        prev = f"{name}.add{i}"
    steps.append((name, lambda e, p=prev: e[p], (prev,)))
    return steps


def _log_steps(src: str, out: str):
    """`prng._log`'s float64 steps on ``e[src]``."""
    L = prng._LG
    return [
        ("log.bits", lambda e: e[src].view(torch.int64), (src,)),
        ("log.k0", lambda e: (e["log.bits"] >> 52) - 1023, ("log.bits",)),
        ("log.m0", lambda e: ((e["log.bits"] & ((1 << 52) - 1))
                              | (1023 << 52)).view(torch.float64),
         ("log.bits",)),
        ("log.big", lambda e: e["log.m0"] > prng._SQRT2, ("log.m0",)),
        ("log.m", lambda e: torch.where(e["log.big"], e["log.m0"] * 0.5,
                                        e["log.m0"]), ("log.big", "log.m0")),
        ("log.k", lambda e: (e["log.k0"] + e["log.big"].to(torch.int64)
                             ).to(torch.float64), ("log.k0", "log.big")),
        ("log.f", lambda e: e["log.m"] - 1.0, ("log.m",)),
        ("log.den", lambda e: 2.0 + e["log.f"], ("log.f",)),
        ("log.s", lambda e: e["log.f"] / e["log.den"], ("log.f", "log.den")),
        ("log.z", lambda e: e["log.s"] * e["log.s"], ("log.s",)),
        ("log.w", lambda e: e["log.z"] * e["log.z"], ("log.z",)),
        ("log.t1", lambda e: e["log.w"] * (L[1] + e["log.w"] * (
            L[3] + e["log.w"] * L[5])), ("log.w",)),
        ("log.t2", lambda e: e["log.z"] * (L[0] + e["log.w"] * (
            L[2] + e["log.w"] * (L[4] + e["log.w"] * L[6]))),
         ("log.z", "log.w")),
        ("log.r", lambda e: e["log.t2"] + e["log.t1"], ("log.t2", "log.t1")),
        ("log.hfsq", lambda e: 0.5 * e["log.f"] * e["log.f"], ("log.f",)),
        (out, lambda e: e["log.k"] * prng._LN2_HI - (
            (e["log.hfsq"] - (e["log.s"] * (e["log.hfsq"] + e["log.r"])
                              + e["log.k"] * prng._LN2_LO)) - e["log.f"]),
         ("log.k", "log.hfsq", "log.s", "log.r", "log.f")),
    ]


def steps():
    """The float32 chain of `prng.normal` after the uniform draw ``u``."""
    s = [("neg_u", lambda e: -e["u"], ("u",)),
         ("x", lambda e: e["neg_u"] * e["u"], ("neg_u", "u")),
         ("xx", lambda e: e["x"] * e["x"], ("x",))]
    s += _horner_steps("num", prng._LOG1P_NUM, "x")
    s += _horner_steps("den", prng._LOG1P_DEN, "x")
    s += [("q", lambda e: e["num"] / e["den"], ("num", "den")),
          ("h", lambda e: -0.5 * e["xx"], ("xx",)),
          ("xxx", lambda e: e["x"] * e["xx"], ("x", "xx")),
          ("xxxq", lambda e: e["xxx"] * e["q"], ("xxx", "q")),
          ("hq", lambda e: e["h"] + e["xxxq"], ("h", "xxxq")),
          ("small", lambda e: e["x"] + e["hq"], ("x", "hq")),
          ("x1", lambda e: (e["x"] + 1.0).double(), ("x",))]
    s += _log_steps("x1", "log64")
    s += [("large", lambda e: e["log64"].to(F32), ("log64",)),
          ("log1p", lambda e: torch.where(torch.abs(e["x"])
                                          < prng._LOG1P_SMALL,
                                          e["small"], e["large"]),
           ("x", "small", "large")),
          ("w", lambda e: -e["log1p"], ("log1p",)),
          ("w_lt", lambda e: e["w"] - 2.5, ("w",)),
          # the float32 root alone (the step at fault), then the root
          # `prng.erf_inv` takes: float64, rounded once
          ("sqrt_w_f32", lambda e: torch.sqrt(e["w"]), ("w",)),
          ("sqrt_w", lambda e: torch.sqrt(e["w"].double()).float(),
           ("w",)),
          ("w_ge", lambda e: e["sqrt_w"] - 3.0, ("sqrt_w",))]
    s += _horner_steps("p_lt", prng._ERFINV32_LT5, "w_lt")
    s += _horner_steps("p_ge", prng._ERFINV32_GE5, "w_ge")
    s += [("p", lambda e: torch.where(e["w"] < 5.0, e["p_lt"], e["p_ge"]),
           ("w", "p_lt", "p_ge")),
          ("erfinv", lambda e: torch.where(torch.abs(e["u"]) == 1.0,
                                           e["u"] * math.inf,
                                           e["p"] * e["u"]),
           ("u", "p")),
          ("normal", lambda e: prng.rounded(math.sqrt(2.0), F32)
           * e["erfinv"], ("erfinv",))]
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--n", type=int, default=1000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prng_bisect: needs a CUDA card", file=sys.stderr)
        return 2
    names = list(scenarios.FAMILIES)
    idx = names.index("sensor_noise")
    scen = scenarios.sample("sensor_noise", args.seed + idx, args.n,
                            horizon=240, device="cpu", dtype=F32)
    key = timeline._folded(scen, 120, timeline._SALT_NOISE)
    shape = (args.n, args.n, 3)
    npd = "float32"
    lo = float(np.nextafter(np.array(-1.0, npd), np.array(0.0, npd)))
    u_cpu = prng.uniform(key, shape, F32, lo, 1.0)
    u_card = prng.uniform(key.cuda(), shape, F32, lo, 1.0)
    cpu, card = {"u": u_cpu}, {"u": u_card}
    print(json.dumps({"step": "u", "chain_differ":
                      int((u_card.cpu() != u_cpu).sum()),
                      "elements": u_cpu.numel()}))
    first = None
    for name, fn, ins in steps():
        cpu[name] = fn(cpu)
        card[name] = fn(card)
        alone = fn({k: cpu[k].cuda() for k in ins})
        c = cpu[name]
        chain = int((card[name].cpu() != c).sum())
        lone = int((alone.cpu() != c).sum())
        rec = {"step": name, "chain_differ": chain, "alone_differ": lone}
        if lone and first is None:
            first = name
            bad = (alone.cpu() != c).reshape(-1).nonzero()[:3, 0]
            rec["examples"] = [
                {"inputs": {k: float(cpu[k].reshape(-1)[i]) for k in ins},
                 "cpu": float(c.reshape(-1)[i]),
                 "card": float(alone.cpu().reshape(-1)[i])}
                for i in bad.tolist()]
        print(json.dumps(rec))
    ref = prng.normal(key, shape, F32)
    got = prng.normal(key.cuda(), shape, F32).cpu()
    d = (got - ref).abs()
    print(json.dumps({"summary": True, "first_step_at_fault": first,
                      "normal_differ": int((d > 0).sum()),
                      "normal_max_abs_dz": float(d.max()),
                      "device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
