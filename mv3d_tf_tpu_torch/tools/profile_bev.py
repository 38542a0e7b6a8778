"""Stage times of the BEV rasterizer; the counterpart of
tools/profile_bev.py.

    python -m mv3d_tf_tpu_torch.tools.profile_bev [--batch 8] \\
        [--points 131072] [--iters 10] [--device cuda|cpu]

Splits ops/bev.point_cloud_2_top_fast on --batch scans of --points points
(bench.py:164-176's traffic from seed 0, on the device) into its three
parts: the elementwise prep (range filters, pixel and slice of each point:
ops/bev.slot_keys), the stable sort by slot with its two gathers, and the
placement (ops/bev_cuda.bev_place: the CUDA kernel on a card, its plain
version on the CPU); then their sum and the whole point_cloud_2_top_batch
(on the CPU the plain scatter), with its device busy and idle shares.
The JAX tool jits each part as its own program; eager PyTorch launches a
part's kernels alone as it does in the whole call, so each part is timed
directly with CUDA events.
"""

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="BEV rasterizer stage times")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=131072)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from mv3d_tf_tpu_torch.ops import bev
    from mv3d_tf_tpu_torch.ops.bev_cuda import bev_place
    from mv3d_tf_tpu_torch.tools import profiling as P

    device = torch.device(args.device)
    B, N = args.batch, args.points
    print("device:", P.device_name(device), flush=True)
    rng = np.random.RandomState(0)
    pts = np.zeros((B, N, 4), np.float32)
    pts[..., 0] = rng.rand(B, N) * 80 - 10
    pts[..., 1] = rng.rand(B, N) * 80 - 40
    pts[..., 2] = rng.rand(B, N) * 4 - 3
    pts[..., 3] = rng.rand(B, N)
    points = torch.from_numpy(pts).to(device)
    valid = torch.ones((B, N), dtype=torch.bool, device=device)
    times = {}

    def bench(name, fn):
        ms, out = P.stage_ms(fn, device, iters=args.iters)
        times[name] = ms
        print("  {:32s} {:9.3f} ms/batch {:9.1f} scans/s".format(
            name, ms, B * 1e3 / ms), flush=True)
        return out

    def sort(seg, zh, r):
        seg_s, perm = torch.sort(seg, dim=-1, stable=True)
        return (seg_s.contiguous(), torch.gather(zh, -1, perm),
                torch.gather(r, -1, perm))

    print("== bev stages (batch {}, {} points) ==".format(B, N))
    keys = bench("elementwise prep", lambda: bev.slot_keys(points, valid))
    sorted_ = bench("stable sort + gathers", lambda: sort(*keys))
    bench("placement", lambda: bev_place(*sorted_))
    print("  {:32s} {:9.3f} ms/batch (sum)".format(
        "stage sum", sum(times.values())))
    full = lambda: bev.point_cloud_2_top_batch(points, valid)  # noqa: E731
    bench("WHOLE point_cloud_2_top_batch", full)
    print("  whole call: " + P.busy_line(full, device))
    return times


if __name__ == "__main__":
    main()
