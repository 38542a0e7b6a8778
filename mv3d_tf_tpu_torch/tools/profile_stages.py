"""Stage times of the batched detector, one stage at a time, then the whole
call; the counterpart of tools/profile_stages.py.

    python -m mv3d_tf_tpu_torch.tools.profile_stages [--batch 8] \\
        [--iters 5] [--trace DIR] [--int8] [--device cuda|cpu]

The stages of eval.build_detect_batch_fn in bfloat16 at the reference
shapes (He-scaled weights, inputs from seed 0): both trunks (and each
alone), the RPN head and its softmax, the proposal layer with its NMS,
the ROI pool of both views (the CUDA kernel), the fusion head with the
corner decode; their sum; and the whole call, with its device busy and
idle shares. --int8 adds the int8 PTQ stages (calibrated on 2 frames): the
s2d_int8 extraction (stems and s8 trunks), the int8 ROI pool pair and
the whole int8 call (int8 RPN). --trace writes a torch.profiler Chrome
trace of three whole calls there.

The JAX tool jits each stage as its own program and reads the fused graph
apart, since fusion makes a stage timed alone lie on the TPU
(tools/profile_detect.py:1-12). Eager PyTorch runs a stage's kernels alone
as it runs them in the call, so each stage is timed directly, with CUDA
events (tools/profiling.stage_ms); the sum against the whole call shows
what the stages leave out (host work between them).
"""

import argparse
import os
import os.path as osp


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Detector stage times")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler trace of the whole call here")
    ap.add_argument("--int8", action="store_true",
                    help="also time the int8 PTQ stages")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from mv3d_tf_tpu_torch import eval as E
    from mv3d_tf_tpu_torch import quant as Q
    from mv3d_tf_tpu_torch.models import mv3d, vgg
    from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_fast
    from mv3d_tf_tpu_torch.tools import profiling as P
    from mv3d_tf_tpu_torch.tools.trace_detect import record

    device = torch.device(args.device)
    B = args.batch
    dt = torch.bfloat16
    feat_h, feat_w = P.feat_hw()
    print("device:", P.device_name(device), "batch:", B, flush=True)
    params = P.he_params(device)
    bev, image, calib = P.detector_inputs(B, device)
    means = torch.from_numpy(E.PIXEL_MEANS).to(device)
    times = {}

    def bench(name, fn):
        with torch.inference_mode():
            ms, out = P.stage_ms(fn, device, iters=args.iters)
        times[name] = ms
        print("  {:32s} {:9.3f} ms/batch {:9.1f} frames/s".format(
            name, ms, B * 1e3 / ms), flush=True)
        return out

    print("== stages (bf16, batch {}) ==".format(B))
    c5, c5_2 = bench("trunks (both)", lambda: mv3d.extract_features(
        params, bev, image - means, dtype=dt, stem_impl="fused"))
    bench("  bev trunk only", lambda: vgg.trunk_apply(
        params, bev, "", dt, "fused"))
    bench("  img trunk only", lambda: vgg.trunk_apply(
        params, image - means, "_2", dt, "fused"))
    rpn_cls, rpn_box = bench("rpn head+probs", lambda: mv3d.rpn_head(
        params, c5, dtype=dt))
    rois, flat_bv, flat_img = bench(
        "proposal layer (NMS)", lambda: E.proposals(
            rpn_cls, rpn_box, calib, feat_h, feat_w))
    p1, p2 = bench("roi pool x2", lambda: (
        roi_pool_fast(c5, flat_bv, spatial_scale=1.0 / 8),
        roi_pool_fast(c5_2, flat_img, spatial_scale=1.0 / 8)))

    def head():
        _, cls_prob, bbox_pred = mv3d.fusion_head(params, p1, p2, dtype=dt)
        return E._outputs(rois, cls_prob, bbox_pred)

    bench("fusion head + decode", head)
    stages = ("trunks (both)", "rpn head+probs", "proposal layer (NMS)",
              "roi pool x2", "fusion head + decode")
    print("  {:32s} {:9.3f} ms/batch (sum)".format(
        "stage sum", sum(times[k] for k in stages)))

    detect = E.build_detect_batch_fn(feat_h=feat_h, feat_w=feat_w,
                                     compute_dtype=dt)
    full = lambda: detect(params, bev, image, calib)  # noqa: E731
    bench("WHOLE call", full)
    print("  whole call: " + P.busy_line(full, device))

    if args.int8:
        img_ms = image - means
        state = Q.build_quant_state(params, bev[:2], img_ms[:2])
        trunk_w = {k: Q.prepare_trunk_weights(state[k])
                   for k in ("trunk_bv", "trunk_img")}
        cache = {"trunk_bv": {}, "trunk_img": {}}
        print("== int8 stages ==")
        fbv, s_bv, fim, s_im = bench(
            "int8 extract (s2d_int8)", lambda: Q.extract_features_int8(
                params, state, bev, img_ms, trunk_w, cache,
                stem="s2d_int8"))
        bench("roi pool x2 on s8 maps", lambda: (
            roi_pool_fast(fbv, flat_bv, spatial_scale=1.0 / 8),
            roi_pool_fast(fim, flat_img, spatial_scale=1.0 / 8)))
        detect8 = E.build_detect_batch_fn(
            feat_h=feat_h, feat_w=feat_w, quant=state, stem_impl="s2d_int8",
            quant_rpn=True)
        full8 = lambda: detect8(params, bev, image, calib)  # noqa: E731
        bench("WHOLE int8 call", full8)
        print("  whole int8 call: " + P.busy_line(full8, device))

    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        path, _ = record(full, 3, args.trace, device)
        print("trace written to", osp.abspath(path))
    return times


if __name__ == "__main__":
    main()
