"""What the program's spans cost and what they read, for one cell, in one
process on the card: after the cell's set-up, --pairs pairs of windows of
--seconds each, the program's tracing off in one and on in the other (the
order alternating), then the spans' reading (lib/spans.py) and the device
idle share of lib/trace.py over as many calls.

    python3 benchmark/tools/span_table.py --workload <cell> --seed <n> \\
        [--pairs 3] [--seconds 10] [--alternate 400] \\
        [--out span_table.jsonl]

A window's numbers drift with the host by more than tracing costs, so
--alternate calls follow in pairs on one item, tracing on in one call of
each pair (first in every other pair): the medians of their latencies on
and off, and of each pair's difference.

Prints one JSON line: the card, each window's end-to-end numbers with its
tracing state, the alternating calls, the reading (per span: wall and
self ms, launches, device and host-to-device ms, idle shares, counters,
the hand kernels' launch counters beside their trace events) and
lib/trace.py's idle share.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def alternating(call, n):
    """n calls in pairs on one item each, tracing on in one call of a pair
    and off in the other, the on call second in every other pair: ms
    medians on, off, and of each pair's on less off."""
    from mv3d_tf_tpu_torch import trace
    on, off = [], []
    for i in range(n):
        k = i // 2
        tracing = (i % 2 == 1) != (k % 2 == 1)   # off on, on off, ...
        with trace.tracing() if tracing else contextlib.nullcontext():
            t0 = time.perf_counter()
            call(k)
            (on if tracing else off).append((time.perf_counter() - t0) * 1e3)
        trace.clear()
    return {"calls": n, "on_ms": statistics.median(on),
            "off_ms": statistics.median(off),
            "on_less_off_ms": statistics.median(
                a - b for a, b in zip(on, off))}


def measure(name, seed, pairs, seconds, device="cuda", cell_files=None,
            alternate=0):
    from benchmark.lib import harness as H
    from benchmark.lib import spans
    from benchmark.lib import trace as LT
    from mv3d_tf_tpu_torch import trace
    cell, work, cfg, traffic, *_ = cell_files or H.load_cell(name)
    drv = H.driver_class(work["driver"])(cfg, traffic, seed, device)
    windows = []
    for k in range(2 * pairs):
        on = (k % 2 == 1) != (k // 2 % 2 == 1)      # off on, on off, ...
        with trace.tracing() if on else contextlib.nullcontext():
            w = H.closed_loop(drv.call, seconds)
        trace.clear()
        windows.append({"tracing": on, "calls": w["calls"],
                        **H.end_to_end(w, drv.ITEMS_METRIC)})
    out = {"workload": name, "seed": seed, "windows": windows,
           "alternating": alternating(drv.call, alternate) if alternate
           else None, "reading": spans.record(drv.call, device)}
    prof = LT.profile(lambda: drv.call(0), H.TRACE_CALLS) \
        if device == "cuda" else None
    out["device_idle_pct"] = (None if not prof else
                              100.0 * (1 - prof["busy_s"] / prof["window_s"]))
    drv.release()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--alternate", type=int, default=400)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    out = {"device": torch.cuda.get_device_name(0)}
    out.update(measure(args.workload, args.seed, args.pairs, args.seconds,
                       alternate=args.alternate))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
