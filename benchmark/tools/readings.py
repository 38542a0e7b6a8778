"""The comparison's readings of a cell over many seeds, in one process:
the program's (a short window at the cell's own load, long enough to finish
every frame of the pool) and, with --control, the control's: the reference
computed one precision step below the configuration's (float8 e4m3 for
bfloat16) in the program's place. The limits in
benchmark/workloads/<cell>.json are set from these readings.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1 2 3 \\
        [--control] [--seconds 2] [--out readings.jsonl]

One JSON line per seed and side on standard output (and in --out).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def readings(name, seeds, seconds, control, device="cuda", cell_files=None,
             log=print):
    """[{"seed", "side", "readings", "s"}] for each seed: the program's,
    then, with control, the control's."""
    from benchmark.lib import harness as H
    cell, work, cfg, traffic, *_ = cell_files or H.load_cell(name)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        drv = H.driver_class(work["driver"])(cfg, traffic, seed, device)
        H.closed_loop(drv.call, seconds)
        drv.release()
        sides = [("program", False)] + ([("control", True)] if control
                                        else [])
        for side, ctl in sides:
            r = {"seed": seed, "side": side, "readings": drv.judge(ctl),
                 "s": time.perf_counter() - t0}
            log(json.dumps(r))
            out.append(r)
        del drv
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = readings(args.workload, args.seeds, args.seconds, args.control)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
