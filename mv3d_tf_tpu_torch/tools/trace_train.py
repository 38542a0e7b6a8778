"""A torch.profiler trace of the train step and its top-op table; the
counterpart of tools/trace_train.py.

    python -m mv3d_tf_tpu_torch.tools.trace_train [--steps 10] \\
        [--stem s2d] [--nms auto|blocked_fixed] [--pre-nms N] \\
        [--dtype bf16|f32] [--out DIR] [--top 30] [--parse-only] \\
        [--device cuda|cpu]

Builds train.build_train_step at the reference batch-1 recipe shapes
(601x601x9 BEV, 384x1248 image, pre/post-NMS 12000/2000, 128 rois,
train_mv.py:159-183) from He-scaled weights, with 4 gt cars and draws from
a seeded generator; warms it, records --steps steps (each ending in a
synchronize) and parses the trace with trace_detect.parse_trace: the top
device kernels, the hand kernels (the ROI pool and its gradient) and the
device's idle gaps. The JAX tool traces one fused jitted step; the
port's step is eager, so its kernels are the step's own.
"""

import argparse
import os.path as osp
import time

from mv3d_tf_tpu_torch.tools.trace_detect import parse_trace, record


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Trace the train step")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--stem", default=None, choices=[None, "s2d"])
    ap.add_argument("--nms", default="auto",
                    choices=["auto", "blocked_fixed"])
    ap.add_argument("--pre-nms", type=int, default=None,
                    help="pre-NMS top-K (default 12000)")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--out", default=osp.join("output", "trace_train"))
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--parse-only", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def build_step(device, dtype, seed=0, **kw):
    """(run, params) where run() takes one train step at the reference
    shapes (tools/profiling's), on fresh He params and a seeded draw
    generator; kw goes to train.build_train_step."""
    import torch

    from mv3d_tf_tpu_torch import train
    from mv3d_tf_tpu_torch.tools import profiling as P
    feat_h, feat_w = P.feat_hw()
    kw.setdefault("pre_nms_top_n", P.TRAIN_PRE_NMS)
    kw.setdefault("post_nms_top_n", P.TRAIN_POST_NMS)
    kw.setdefault("rois_per_image", P.TRAIN_ROIS)
    step, make_opt = train.build_train_step(
        feat_h=feat_h, feat_w=feat_w, compute_dtype=dtype, **kw)
    params = P.he_params(device, seed)
    opt = make_opt(params)
    batch = P.train_batch(device, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw_args = (feat_h * feat_w * 4, kw["post_nms_top_n"] + P.MAX_GT,
                 kw["rois_per_image"], P.FC_DIM, 0.5, device)

    def run():
        return step(params, opt, batch, train.make_draws(gen, *draw_args))

    return run, params


def main(argv=None):
    args = parse_args(argv)
    path = osp.join(args.out, "trace.json")
    if args.parse_only:
        return parse_trace(path, top=args.top, steps=args.steps)

    import torch

    from mv3d_tf_tpu_torch.tools import profiling as P
    device = torch.device(args.device)
    print("device:", P.device_name(device), "stem:", args.stem, "nms:",
          args.nms, "pre-nms:", args.pre_nms, "dtype:", args.dtype,
          flush=True)
    kw = {"stem_impl": args.stem, "nms_impl": args.nms}
    if args.pre_nms is not None:
        kw["pre_nms_top_n"] = args.pre_nms
    run, _ = build_step(device, torch.bfloat16 if args.dtype == "bf16"
                        else None, **kw)
    t0 = time.perf_counter()
    m = run()
    P.sync(device)
    print("first step: {:.1f}s, loss {:.5f}".format(
        time.perf_counter() - t0, m["loss"].item()))
    for _ in range(2):
        run()
    path, ms = record(run, args.steps, args.out, device)
    print("traced {} steps at {:.1f} ms/iter; trace {}".format(
        args.steps, ms, path), flush=True)
    return parse_trace(path, top=args.top, steps=args.steps)


if __name__ == "__main__":
    main()
