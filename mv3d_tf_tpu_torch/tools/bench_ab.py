"""A/B bench of the batched detector (or the train step) under one toggle
per invocation: the counterpart of tools/bench_ab.py.

    python -m mv3d_tf_tpu_torch.tools.bench_ab [--batch N] [--iters 10] \\
        [--stem NAME] [--int8 [--int8-head]
        [--int8-rpn] [--no-quant-pool]] [--pre-nms K]
        [--nms auto|blocked_fixed] [--train] [--device cuda|cpu]

It times exactly eval.build_detect_batch_fn (with --train, train.
build_train_step at --batch 1, the reference recipe, and the mean-gradient
step of parallel/mesh.build_parallel_train_step on one process above it) at
the reference shapes with He-scaled weights and inputs from seed 0: one
first call, then three runs of --iters calls between CUDA events, the
fastest kept. --int8 calibrates on a fixed slice of 4 frames (at most the
batch) and runs the int8 detector; --stem picks the stem by a name of
models/vgg.STEMS (s2d_int8 and int8 only with --int8). A detector whose
blocked_fixed certificate fails on a frame exits 3 and reports no time.
Progress goes to stderr; the last line of stdout is a JSON object of the
result.

--rois-per-step, --pool-cwin and --pool-bins tile the Pallas ROI pool, and
--conv-impl pallas/hybrid/dots/im2col names TPU lowerings of the int8
convs: the port refuses them (its integers are the same for every
lowering).
"""

import argparse
import json
import sys

TPU_KNOBS = ("rois_per_step", "pool_cwin", "pool_bins")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    from mv3d_tf_tpu_torch.models.vgg import INT8_STEMS, STEMS
    ap = argparse.ArgumentParser(description="A/B bench of the detector")
    ap.add_argument("--batch", type=int, default=None,
                    help="frames per call (default 8; 1 with --train)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--stem", default="fused", choices=list(STEMS))
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--int8-head", action="store_true",
                    help="also quantize the fusion head (fc6/fc7)")
    ap.add_argument("--int8-rpn", action="store_true",
                    help="also quantize the RPN 3x3 conv")
    ap.add_argument("--no-quant-pool", action="store_true",
                    help="int8: pool dequantized bf16 maps")
    ap.add_argument("--pre-nms", type=int, default=None,
                    help="pre-NMS top-K (default: detect 6000, train 12000)")
    ap.add_argument("--nms", default="auto", choices=["auto",
                                                      "blocked_fixed"])
    ap.add_argument("--train", action="store_true",
                    help="time the train step instead of the detector")
    ap.add_argument("--conv-impl", default="xla",
                    choices=["xla", "pallas", "hybrid", "dots", "im2col"],
                    help="TPU lowerings of the int8 convs: refused")
    ap.add_argument("--rois-per-step", type=int, default=None,
                    help="a Pallas ROI-pool tiling: refused")
    ap.add_argument("--pool-cwin", type=int, default=None,
                    help="a Pallas ROI-pool tiling: refused")
    ap.add_argument("--pool-bins", default=None, choices=["shared", "window"],
                    help="a Pallas ROI-pool tiling: refused")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    for knob in TPU_KNOBS:
        if getattr(args, knob) is not None:
            raise SystemExit("--%s tiles the TPU's Pallas ROI pool; the port "
                             "has no such knob" % knob.replace("_", "-"))
    if args.conv_impl != "xla":
        raise SystemExit("--conv-impl %s names a TPU lowering of the int8 "
                         "convs; the port runs one s8 kernel for every "
                         "conv_impl" % args.conv_impl)
    if STEMS[args.stem] in INT8_STEMS and not args.int8:
        raise SystemExit("--stem %s needs --int8" % args.stem)
    if args.batch is None:
        args.batch = 1 if args.train else 8
    return args


def best_ms(fn, device, iters):
    """The fastest of three runs of iters calls, ms per call, after one
    first call; CUDA events on a card, the host clock on the CPU."""
    from mv3d_tf_tpu_torch.tools.profiling import stage_ms
    fn()
    runs = [stage_ms(fn, device, iters=iters, warmup=0) for _ in range(3)]
    return min(ms for ms, _ in runs), runs[-1][1]


def main(argv=None):
    args = parse_args(argv)
    import torch

    from mv3d_tf_tpu_torch import eval as E
    from mv3d_tf_tpu_torch.tools import profiling as P

    device = torch.device(args.device)
    B = args.batch
    log("device:", P.device_name(device), "stem:", args.stem, "batch:", B,
        "int8:", args.int8, "train:", args.train)
    params = P.he_params(device)
    result = {"device": P.device_name(device), "batch": B,
              "stem": args.stem, "int8": args.int8, "train": args.train}
    if args.train:
        result.update(bench_train(args, params, device))
        print(json.dumps(result))
        return result

    bev, image, calib = P.detector_inputs(B, device)
    quant = None
    feat_h, feat_w = P.feat_hw()
    if args.int8:
        from mv3d_tf_tpu_torch import quant as Q
        nc = min(4, B)
        img_ms = image[:nc] - torch.from_numpy(E.PIXEL_MEANS).to(device)
        pool_bv = pool_img = None
        if args.int8_head:
            pool_bv, pool_img = Q.calibrate_pooled_features(
                params, bev[:nc], img_ms, calib[:nc], feat_h, feat_w)
        quant = Q.build_quant_state(params, bev[:nc], img_ms,
                                    pooled_bv=pool_bv, pooled_img=pool_img)
    detect = E.build_detect_batch_fn(
        feat_h=feat_h, feat_w=feat_w, compute_dtype=torch.bfloat16,
        quant=quant, stem_impl=args.stem, quant_rpn=args.int8_rpn,
        pre_nms_top_n=args.pre_nms or 6000,
        quant_pool=not args.no_quant_pool, nms_impl=args.nms)
    ms, out = best_ms(lambda: detect(params, bev, image, calib), device,
                      args.iters)
    if "nms_converged" in out:
        conv = out["nms_converged"].cpu()
        log("nms_converged: %d/%d frames" % (int(conv.sum()), conv.numel()))
        if not conv.all():
            log("the blocked_fixed certificate failed on %d frame(s); no "
                "time is reported" % int((~conv).sum()))
            sys.exit(3)
    log("detect: %.3f ms/batch -> %.2f frames/s" % (ms, B * 1e3 / ms))
    result.update(mode="detect", ms_per_batch=ms, frames_per_s=B * 1e3 / ms)
    print(json.dumps(result))
    return result


def bench_train(args, params, device):
    """The train step at the reference shapes: train.build_train_step on
    one frame, or the one-process mean-gradient step over --batch frames."""
    from mv3d_tf_tpu_torch import train as T
    from mv3d_tf_tpu_torch.models.vgg import STEMS
    from mv3d_tf_tpu_torch.tools import profiling as P
    import torch

    stem = STEMS[args.stem]
    kw = dict(compute_dtype=torch.bfloat16, nms_impl=args.nms,
              feat_h=P.feat_hw()[0], feat_w=P.feat_hw()[1],
              pre_nms_top_n=args.pre_nms or P.TRAIN_PRE_NMS,
              post_nms_top_n=P.TRAIN_POST_NMS,
              rois_per_image=P.TRAIN_ROIS,
              stem_impl="s2d" if stem == "s2d" else None)
    if stem not in ("fused", "literal", "s2d"):
        raise SystemExit("--train takes a differentiable stem: literal "
                         "(the default's) or s2d")
    B = args.batch
    frames = [P.train_batch(device, seed=b) for b in range(B)]
    gen = torch.Generator(device=device).manual_seed(0)
    fh, fw = P.feat_hw()
    draws = [T.make_draws(gen, fh * fw * 4, P.TRAIN_POST_NMS + P.MAX_GT,
                          P.TRAIN_ROIS, params["fc6_1"].weight.shape[0], 0.5,
                          device) for _ in range(B)]
    if B == 1:
        step, make_opt = T.build_train_step(**kw)
        opt = make_opt(params)
        fn = lambda: step(params, opt, frames[0], draws[0])  # noqa: E731
    else:
        from mv3d_tf_tpu_torch.parallel.mesh import build_parallel_train_step
        step, make_opt = build_parallel_train_step(None, **kw)
        opt = make_opt(params)
        batch = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
        fn = lambda: step(params, opt, batch, draws)  # noqa: E731
    ms, metrics = best_ms(fn, device, args.iters)
    log("train step: %.3f ms/iter, %.2f frames/s (batch %d, stem %s), "
        "loss %.4f" % (ms, B * 1e3 / ms, B, kw["stem_impl"] or "literal",
                       metrics["loss"].item()))
    return {"mode": "train", "ms_per_step": ms, "frames_per_s": B * 1e3 / ms,
            "loss": metrics["loss"].item()}


if __name__ == "__main__":
    main()
