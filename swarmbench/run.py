"""Run one benchmark cell once and print its result line.

    python3 swarmbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration and its traffic are named in BENCHMARK.json.
The run fails (exit code 2, no result) without a CUDA card, or with fewer
cards than the cell asks for. Its last lines on standard error are the
numbers that decided ``correct``, each beside its limit; its last line on
standard output is the result.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aclswarm_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run must not hold."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"swarmbench [{time.time() - T_START:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict | None = None,
             cell=None, t_start: float | None = None) -> dict:
    """One run of the cell: set-up, window, replay and checks. Returns the
    result dict (the contract's keys, then ``checks``)."""
    import torch

    from swarmbench import harness, judge
    from swarmbench import trace as tracelib

    bench = bench or harness.load_json(ROOT / "BENCHMARK.json")
    cell = cell or harness.load_cell(name, bench)
    cuda = torch.device(device).type == "cuda"
    tel = trace and harness.needs_telemetry(cell, bench)
    import aclswarm_torch  # noqa: F401
    if cuda:
        torch.cuda.init()
    log("the program imported, the card initialized")
    tm: dict = {}
    S = harness.build(cell.config, cell.traffic, seed, device, telemetry=tel,
                      timings=tm)
    log(f"inputs drawn in {tm['draw_s']:.2f} s, gains designed in "
        f"{tm['design_s']:.2f} s")
    # one warm-up chunk, thrown away: every kernel built, every shape seen
    state, carry = harness.clone_tree(S.start), harness.clone_tree(S.carry)
    harness.run_chunk(S, state, carry)
    del state, carry
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.time() - (T_START if t_start is None else t_start)
    log(f"set-up done in {setup_s:.2f} s")

    spans = harness.SpanTimer() if trace else None
    if spans is not None:
        with harness.patched(spans.wrappers()):
            w = harness.run_window(S, seconds, trace=True, spans=spans)
    else:
        w = harness.run_window(S, seconds)
    cs = sorted(w.chunk_s)
    log(f"window: {w.ticks} ticks in {w.seconds:.3f} s; chunks {len(cs)}, "
        f"s min {cs[0]:.4f} median {cs[len(cs) // 2]:.4f} max {cs[-1]:.4f}")
    result = {"correct": False, "attempted": w.attempted, "failed": w.failed}
    if trace:
        tel_last = w.records[-1][1].get("tel")
        reading = tracelib.reading(S, w, spans, telemetry=tel_last)
        result["metrics"] = harness.per_layer(cell, bench, reading)
    else:
        result["metrics"] = {
            "sim_s_per_s": {"value": harness.sim_s_per_s(S, w),
                            "unit": "s/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    dev = harness.device_info(cuda)
    dev["memory_peak_bytes"] = int(w.peak_bytes)
    if trace:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
    result["device"] = dev
    if trace:
        result["breakdown"] = tracelib.breakdown(reading)

    # the checks, after the window, once the peak has been read
    records = w.records
    del w
    cap, recs, carry_in = judge.replay(S, seed, len(records))
    log("replayed the sampled chunks")
    numbers = {"replay_diff": judge.replay_diff(records, recs)}
    numbers.update(judge.gain_numbers(S, S.gains, seed))
    log("gain designs checked")
    numbers.update(judge.tick_numbers(S, cap, recs, carry_in))
    log("reference checks done")
    ok, checks = judge.checks(numbers, cell.workload["limits"])
    result["correct"] = ok
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available():
        print("swarmbench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 2
    from swarmbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, bench)
    if torch.cuda.device_count() < int(cell.entry["chips"]):
        print(f"swarmbench: {args.workload} needs {cell.entry['chips']} "
              f"cards, {torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench, cell=cell)
    bad = loaded_forbidden()
    if bad:
        print(f"swarmbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.json_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
