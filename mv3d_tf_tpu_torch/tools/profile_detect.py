"""Cumulative-prefix profile of the batched int8 detector: the counterpart of
tools/profile_detect.py.

    python -m mv3d_tf_tpu_torch.tools.profile_detect [--batch 8] \\
        [--iters 10] [--device cuda|cpu]

Times growing prefixes of the int8 detector (PTQ calibrated on the batch,
the bf16 literal stems, int8 conv2-5 on weights prepared once) at the
reference shapes with He-scaled weights and inputs from seed 0:
  P1 both stems (bf16);
  P2 + the int8 conv2-5 of both trunks (dequantized to bf16);
  P3 + the RPN head, the proposal layer and its NMS;
  P4 + the ROI pool of both views;
  P5 the whole int8 detector (eval.build_detect_batch_fn(quant=...));
then the whole bf16 detector. Each prefix is timed by CUDA events around
--iters calls after a warm-up (profiling.stage_ms); the successive
differences give each stage's time in the context of what runs before it,
its host launches overlapping the device work of the stages before
(profile_stages times each stage alone). The last line of stdout is a JSON
object of the times.
"""

import argparse
import json
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Prefix profile, int8 detector")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
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

    device = torch.device(args.device)
    B, bf16 = args.batch, torch.bfloat16
    log("device:", P.device_name(device), "batch:", B)
    params = P.he_params(device)
    bev, image, calib = P.detector_inputs(B, device)
    img_ms = image - torch.from_numpy(E.PIXEL_MEANS).to(device)
    fh, fw = P.feat_hw()
    qs = Q.build_quant_state(params, bev, img_ms)
    trunk_w = {k: Q.prepare_trunk_weights(qs[k])
               for k in ("trunk_bv", "trunk_img")}

    def stems():
        return tuple(vgg.stem_apply("literal", x,
                                    *vgg.layer(params, "conv1_1" + sfx),
                                    *vgg.layer(params, "conv1_2" + sfx),
                                    dtype=bf16)
                     for x, sfx in ((bev, ""), (img_ms, "_2")))

    def trunks():
        out = []
        for key, s in zip(("trunk_bv", "trunk_img"), stems()):
            f, scale = Q.trunk_apply_int8_from_stem(qs[key], s, trunk_w[key])
            out.append(E._dequant(f, scale))
        return out

    def proposals():
        c5, c5_2 = trunks()
        rpn_cls, rpn_box = mv3d.rpn_head(params, c5, dtype=bf16)
        return (c5, c5_2) + E.proposals(rpn_cls, rpn_box, calib, fh, fw)

    def pools():
        c5, c5_2, _, flat_bv, flat_img = proposals()
        return (roi_pool_fast(c5, flat_bv, spatial_scale=1.0 / 8),
                roi_pool_fast(c5_2, flat_img, spatial_scale=1.0 / 8))

    detect_q = E.build_detect_batch_fn(feat_h=fh, feat_w=fw,
                                       compute_dtype=bf16, quant=qs)
    detect_f = E.build_detect_batch_fn(feat_h=fh, feat_w=fw,
                                       compute_dtype=bf16)
    prefixes = (("P1 stems (bf16, both trunks)", stems),
                ("P2 +int8 conv2-5", trunks),
                ("P3 +rpn+proposal+nms", proposals),
                ("P4 +dual roi pool", pools),
                ("P5 full int8 detect",
                 lambda: detect_q(params, bev, image, calib)))
    times = []
    with torch.inference_mode():
        for name, fn in prefixes:
            ms = P.stage_ms(fn, device, iters=args.iters)[0]
            times.append((name, ms))
            log("%-36s %9.3f ms" % (name, ms))
        log("--- successive deltas (stage attribution) ---")
        prev = 0.0
        for name, ms in times:
            log("%-36s %9.3f ms (%+.3f)" % (name, ms, ms - prev))
            prev = ms
        bf16_ms = P.stage_ms(lambda: detect_f(params, bev, image, calib),
                             device, iters=args.iters)[0]
    log("%-36s %9.3f ms" % ("bf16 full detect", bf16_ms))
    result = {"device": P.device_name(device), "batch": B,
              "prefixes": times, "bf16_full_ms": bf16_ms}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
