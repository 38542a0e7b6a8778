"""The int8 yardstick: the port's s8 kernels against the library at the MV3D
trunk's conv shapes; the counterpart of tools/microbench_int8.py.

    python -m mv3d_tf_tpu_torch.tools.microbench_int8 [--iters 20] \\
        [--batch 8] [--gemm 4096] [--device cuda|cpu]

First an N^3 GEMM (--gemm N): the s8 GEMM kernel (ops/conv_s8.matmul_s8_nk
on a weight prepared once), torch._int_mm and a bf16 torch.matmul. Then at
each 3x3 SAME conv shape of the int8 trunks (B frames: conv2_2 at 300x300x128,
conv3_2 at 150x150x256, conv5_x at 75x75x512 on the BEV, conv5 at
48x156x512 on the image):
  * the s8 conv kernel (conv3x3_s8_nk on its prepared weight, requant
    fused, int8 out);
  * im2col + the s8 GEMM kernel (s32 out);
  * im2col + torch._int_mm (s32 out);
  * the bf16 conv of torch.nn.functional.conv2d, channels-last (cuDNN on
    a card).
Each is timed by CUDA events over --iters calls after a warm-up, and
reported in ms and TOP/s (2 * B*H*W * 9*C * N operations) beside the card's
dense int8 and bf16 peaks (1979 and 989 TOP/s, the H100 SXM data sheet).
The im2col rows are built once, outside the timed calls. The last line of
stdout is a JSON list of the rows.

--pallas measured the TPU's Pallas kernels: the port refuses it (its
kernels are always measured).
"""

import argparse
import json
import sys

INT8_PEAK, BF16_PEAK = 1979e12, 989e12   # dense H100 SXM, ops/s
# (H, W, C, N, name): the int8 trunks' 3x3 convs after the stem
SHAPES = ((300, 300, 128, 128, "conv2_2"), (150, 150, 256, 256, "conv3_2"),
          (75, 75, 512, 512, "conv5_x"), (48, 156, 512, 512, "conv5_img"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="int8 microbenchmarks")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gemm", type=int, default=4096,
                    help="the square GEMM's side")
    ap.add_argument("--pallas", action="store_true",
                    help="the TPU's Pallas kernels: refused")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.pallas:
        raise SystemExit("--pallas measured the TPU's Pallas kernels; the "
                         "port's s8 kernels are always measured")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch
    import torch.nn.functional as F

    from mv3d_tf_tpu_torch.ops import conv_s8 as S8
    from mv3d_tf_tpu_torch.tools import profiling as P

    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    log("device:", P.device_name(dev))

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def ms(fn):
        return P.stage_ms(fn, dev, iters=args.iters, warmup=2)[0]

    rows = []

    def row(name, impl, t, ops, peak):
        r = {"shape": name, "impl": impl, "ms": t, "tops": ops / t / 1e9,
             "peak_share": ops / t / 1e9 / (peak / 1e12)}
        rows.append(r)
        log("%-10s %-22s %8.3f ms %8.1f TOP/s (%.3f of peak)"
            % (name, impl, t, r["tops"], r["peak_share"]))

    n = args.gemm
    a, b = s8(n, n), s8(n, n)
    b_nk = S8.prepare_s8_gemm_weight(b)
    af, bf = (t.to(torch.bfloat16) for t in (a, b))
    ops = 2 * n ** 3
    name = "gemm%d" % n
    row(name, "s8 GEMM kernel", ms(lambda: S8.matmul_s8_nk(a, b_nk)), ops,
        INT8_PEAK)
    b_cm = b.t().contiguous().t()       # column-major, as cuBLASLt takes it
    row(name, "torch._int_mm", ms(lambda: torch._int_mm(a, b_cm)), ops,
        INT8_PEAK)
    row(name, "bf16 matmul", ms(lambda: af @ bf), ops, BF16_PEAK)
    del a, b, b_cm, b_nk, af, bf

    B = args.batch
    for H, W, C, N, name in SHAPES:
        x = torch.randint(0, 128, (B, H, W, C), generator=gen, device=dev,
                          dtype=torch.int8)
        w = s8(3, 3, C, N)
        k = torch.rand(N, generator=gen, device=dev) * 1e-3
        bias = torch.rand(N, generator=gen, device=dev)
        w_nk = S8.prepare_s8_conv_weight(w)
        cols, _ = S8._im2col(x, 3, 3, 1)
        wg = w.reshape(9 * C, N)
        wg_nk = S8.prepare_s8_gemm_weight(wg)
        wg_cm = wg.t().contiguous().t()
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)       # channels-last
        wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        ops = 2 * B * H * W * 9 * C * N
        row(name, "s8 conv kernel",
            ms(lambda: S8.conv3x3_s8_nk(x, w_nk, k, bias)), ops, INT8_PEAK)
        row(name, "im2col + s8 GEMM kernel",
            ms(lambda: S8.matmul_s8_nk(cols, wg_nk)), ops, INT8_PEAK)
        row(name, "im2col + torch._int_mm",
            ms(lambda: torch._int_mm(cols, wg_cm)), ops, INT8_PEAK)
        row(name, "bf16 conv2d (cuDNN)",
            ms(lambda: F.conv2d(xb, wb, padding=1)), ops, BF16_PEAK)
        del x, cols, xb
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
