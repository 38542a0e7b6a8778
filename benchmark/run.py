"""Run one cell of the port's benchmark once, on the card it finds.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up makes the weights and the traffic from the seed and warms the
cell's shapes; then the window calls the program back to back for
--seconds; with --trace 1 the per-layer readers follow. The reference then
judges what the window produced. The last line of standard output is the
result (BENCHMARK.json's contract); the numbers compared, each with its
limit, are the last lines of standard error. Without a card, or with fewer
than the cell asks for, it prints no result and exits 2; with a JAX module
loaded once the window has closed, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's and the toolchains' caches stay inside the checkout, at
# fixed paths, so that only a checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import harness as H

    files = H.load_cell(args.workload)
    chips = files[0].get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("no result: the cell needs %d CUDA device(s), found %d"
              % (chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result = H.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=T_START, cell_files=files)
    bad = H.forbidden_modules()
    if bad:
        print("no result: JAX modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    H.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
