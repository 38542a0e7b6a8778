"""Hold every hand-written kernel of the port to its plain version on the
card, at one main-path shape each: the counterpart of tools/tpu_selfcheck.py.

    python -m mv3d_tf_tpu_torch.tools.gpu_selfcheck [--device cuda|cpu] \\
        [--golden tests/golden_torch_fullshape.npz]

Prints [ok] or [FAIL] per check and exits 0 only if every check passes.
The checks keep tpu_selfcheck's numbering:
  1. the BEV raster (sort + placement kernel) against the numpy twin, bit
     for bit;
  2. the ROI pool forward against the plain pool, bit for bit;
  3. the ROI pool backward against the plain gradient, within 1e-5 of the
     max;
  4. the literal stem's kernel against the two bf16 convs and the pool,
     within 2^-7 of the max;
  5. the proposal layer's NMS routes: the greedy loop, the blocked scan and
     the fixed-round blocked scan with its certificate, keep sets equal
     (this replaces tpu_selfcheck's construction rules, a TPU workaround);
  6. the float32 detector against the golden that the JAX package wrote
     (its recipe is in the npz): valid count equal, scores within 2e-2,
     BEV boxes within 1.0 pixel, tpu_selfcheck's bands;
  7. the s8 3x3 and 2x2 convs against their plain versions, bit for bit;
  8. the fused s2d stem against its plain version, within 2^-7 (bf16) and
     1e-5 (float32) of the max;
  9. the ROI pool on int8 maps, bit for bit;
 10. the s8 GEMM against its plain version, bit for bit (after
     tpu_selfcheck's time).
With --device cpu every wrapper takes its plain version, so the checks run
the plain versions against themselves (the tests' route).
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "golden_torch_fullshape.npz")
STEM_TOL = 2 ** -7
BWD_RTOL, BWD_ATOL = 1e-5, 1e-7
# one main-path shape per check (the tests shrink them)
SHAPES = {
    "bev": (8, 131072),                 # scans x points (bench.py:164-176)
    "roi_map": (75, 75, 512),           # the BEV conv5_3
    "rois": 60,
    "stem": (2, 120, 601, 9),           # BEV rows through both stems
    "nms_feat": 75,
    "nms": (6000, 300),                 # the detector's pre/post-NMS
    "conv3x3": (2, 75, 75, 256, 256),   # B, H, W, C, N
    "conv2x2": (2, 151, 157, 256, 256),
    "gemm": (300, 2048, 2048),          # fc7 of one frame: M, K, N
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Kernel self-check")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--golden", default=GOLDEN,
                    help="the float32 detector golden of check 6")
    return ap.parse_args(argv)


def _rois(rng, n, extent):
    x1, y1 = rng.rand(n) * extent * 0.9, rng.rand(n) * extent * 0.9
    rois = np.stack([np.zeros(n), x1, y1, x1 + rng.rand(n) * 58 + 2,
                     y1 + rng.rand(n) * 58 + 2], 1).astype(np.float32)
    rois[0] = [0, extent - 8, extent - 8, extent - 1, extent - 1]
    rois[1] = [0, 0, 0, extent - 1, extent - 1]
    return rois


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp(min=1e-6)).item()


def detect_golden(path, device):
    """Check 6: the port's float32 detector on the golden's recipe.
    Returns (ok, detail)."""
    from mv3d_tf_tpu_torch.eval import build_detect_fn
    from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                                  params_from_jax)
    g = np.load(path)
    r = json.loads(str(g["recipe"]))
    rng = np.random.RandomState(r["seed"])
    bev = rng.rand(*r["bev_shape"]).astype(np.float32)
    image = (rng.rand(*r["image_shape"]) * 255).astype(np.float32)
    params = params_from_jax(he_normal_params(r["seed"], fc_dim=r["fc_dim"]),
                             device=device)
    detect = build_detect_fn(feat_h=r["feat_hw"][0], feat_w=r["feat_hw"][1],
                             pre_nms_top_n=r["pre_nms_top_n"],
                             post_nms_top_n=r["post_nms_top_n"])
    out = detect(params, bev, image, g["calib"])
    scores = out["scores"].float().cpu().numpy()
    boxes = out["boxes_bv"].float().cpu().numpy()
    valid = out["valid"].cpu().numpy()
    ds = np.abs(scores - g["scores"]).max()
    db = np.abs(boxes - g["boxes_bv"]).max()
    ok = (int(valid.sum()) == int(g["valid"].sum()) and ds <= 2e-2
          and db <= 1.0)
    return ok, "(valid %d vs %d, max dscore %.3e, max dbox %.3f px)" % (
        int(valid.sum()), int(g["valid"].sum()), ds, db)


def main(argv=None):
    args = parse_args(argv)
    from mv3d_tf_tpu_torch.ops import bev as B
    from mv3d_tf_tpu_torch.ops import conv_s8 as S8
    from mv3d_tf_tpu_torch.ops.roi_pool import (roi_pool, roi_pool_fast,
                                                roi_pool_train,
                                                roi_pool_train_plain)
    from mv3d_tf_tpu_torch.ops.stem_s2d_cuda import (stem_s2d_fused,
                                                     stem_s2d_fused_plain)
    from mv3d_tf_tpu_torch.ops.vgg_stem_cuda import vgg_stem, vgg_stem_plain
    from mv3d_tf_tpu_torch.proposals import proposal_layer_3d

    dev = torch.device(args.device)
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu (the plain versions)", flush=True)
    failures = []

    def check(name, ok, detail=""):
        print("  [{}] {} {}".format("ok" if ok else "FAIL", name, detail),
              flush=True)
        if not ok:
            failures.append(name)

    def t(a):
        return torch.as_tensor(a).to(dev)

    rng = np.random.RandomState(11)

    # 1. the BEV raster
    n_scans, n_pts = SHAPES["bev"]
    pts = np.zeros((n_scans, n_pts, 4), np.float32)
    pts[..., 0] = rng.rand(n_scans, n_pts) * 80 - 10
    pts[..., 1] = rng.rand(n_scans, n_pts) * 80 - 40
    pts[..., 2] = rng.rand(n_scans, n_pts) * 4 - 3
    pts[..., 3] = rng.rand(n_scans, n_pts)
    val = np.ones((n_scans, n_pts), bool)
    got = B.point_cloud_2_top_batch(pts, val, device=dev).cpu().numpy()
    ref = np.stack([B.point_cloud_2_top_np(p) for p in pts])
    check("1 bev raster vs numpy twin (bit-exact)",
          np.array_equal(got, ref),
          "(%d of %d cells differ)" % (int((got != ref).sum()), ref.size))

    # 2. the ROI pool forward
    H, W, C = SHAPES["roi_map"]
    rois = t(_rois(rng, SHAPES["rois"], H * 8))
    feat = t(rng.rand(H, W, C).astype(np.float32))
    got, ref = roi_pool_fast(feat, rois), roi_pool(feat, rois)
    check("2 roi-pool fwd vs plain (bit-exact)", torch.equal(got, ref),
          "(max diff %.2e)" % (got - ref).abs().max().item())

    # 3. the ROI pool backward, on distinct-valued features
    featd = t(rng.permutation(H * W * C).reshape(H, W, C).astype(np.float32))
    dy = t(rng.rand(SHAPES["rois"], 7, 7, C).astype(np.float32))
    grads = []
    for pool in (roi_pool_train, roi_pool_train_plain):
        f = featd.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((pool(f, rois) * dy).sum(), f)[0])
    err = (grads[0] - grads[1]).abs().max().item()
    tol = BWD_RTOL * grads[1].abs().max().item() + BWD_ATOL
    check("3 roi-pool bwd vs plain gradient", err <= tol,
          "(max diff %.2e, tolerance %.2e)" % (err, tol))

    # 4. the literal stem's kernel (weights OIHW)
    x = t(rng.rand(*SHAPES["stem"]).astype(np.float32))
    cin = x.shape[-1]
    w1 = t((rng.rand(64, cin, 3, 3).astype(np.float32) - 0.5) * 0.2)
    b1 = t(rng.rand(64).astype(np.float32) * 0.1)
    w2 = t((rng.rand(64, 64, 3, 3).astype(np.float32) - 0.5) * 0.2)
    b2 = t(rng.rand(64).astype(np.float32) * 0.1)
    with torch.no_grad():
        rel = _rel(vgg_stem(x, w1, b1, w2, b2),
                   vgg_stem_plain(x, w1, b1, w2, b2))
    check("4 literal stem vs two bf16 convs + pool", rel <= STEM_TOL,
          "(rel %.2e)" % rel)

    # 5. the NMS routes of the proposal layer
    from mv3d_tf_tpu_torch.tools.profiling import example_calib
    fh = SHAPES["nms_feat"]
    pre, post = SHAPES["nms"]
    prob = t(rng.rand(1, fh, fh, 8).astype(np.float32))
    deltas = t((rng.rand(1, fh, fh, 24).astype(np.float32) - 0.5) * 0.1)
    calib = t(example_calib())
    kw = dict(pre_nms_top_n=pre, post_nms_top_n=post, nms_thresh=0.7,
              im_h=fh * 8 + 1, im_w=fh * 8 + 1)
    with torch.no_grad():
        runs = {impl: proposal_layer_3d(prob, deltas, calib, fh, fh,
                                        nms_impl=impl, **kw)
                for impl in ("auto", "blocked", "blocked_fixed")}
    n_valid = int(runs["auto"]["valid"].sum())
    check("5 nms greedy runs", n_valid > 0, "(%d valid)" % n_valid)
    for impl in ("blocked", "blocked_fixed"):
        same = all(torch.equal(runs[impl][k], runs["auto"][k])
                   for k in ("rois_bv", "valid"))
        cert = (impl != "blocked_fixed"
                or bool(runs[impl]["nms_converged"].all()))
        check("5 nms %s keep set == greedy%s" % (
            impl, ", certified" if impl == "blocked_fixed" else ""),
            same and cert)

    # 6. the float32 detector against the JAX package's golden
    if os.path.exists(args.golden):
        ok, detail = detect_golden(args.golden, dev)
        check("6 float32 detector vs the JAX golden", ok, detail)
    else:
        check("6 float32 detector vs the JAX golden", False,
              "(no golden at %s)" % args.golden)

    # 7. the s8 convs
    gen = torch.Generator(device=dev).manual_seed(11)

    def s8_case(b, h, w, c, n, taps):
        x = torch.randint(0, 128, (b, h, w, c), generator=gen, device=dev,
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (taps, taps, c, n), generator=gen,
                           device=dev, dtype=torch.int8)
        k = torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4
        bq = torch.rand(n, generator=gen, device=dev) - 0.5
        return x, wq, k, bq

    for name, taps, fn, plain in (
            ("conv3x3", 3, S8.conv3x3_s8, S8.conv3x3_s8_plain),
            ("conv2x2", 2, S8.conv2x2_s8, S8.conv2x2_s8_plain)):
        case = s8_case(*SHAPES[name], taps)
        got, ref = fn(*case), plain(*case)
        check("7 s8 %s vs plain (bit-exact)" % name, torch.equal(got, ref),
              "(%d of %d differ)" % (int((got != ref).sum()), ref.numel()))

    # 8. the fused s2d stem
    xs = t(rng.rand(1, SHAPES["stem"][1] + 1, SHAPES["stem"][2],
                    cin).astype(np.float32))
    with torch.no_grad():
        for dtype, tol in ((torch.bfloat16, STEM_TOL), (torch.float32, 1e-5)):
            rel = _rel(stem_s2d_fused(xs, w1, b1, w2, b2, dtype),
                       stem_s2d_fused_plain(xs, w1, b1, w2, b2, dtype))
            check("8 fused s2d stem %s vs plain" % str(dtype)[6:],
                  rel <= tol, "(rel %.2e)" % rel)

    # 9. the ROI pool on int8 maps
    feat8 = torch.randint(0, 128, (1, H, W, C), generator=gen, device=dev,
                          dtype=torch.int8)
    got, ref = roi_pool_fast(feat8, rois), roi_pool(feat8, rois)
    check("9 roi-pool fwd on int8 maps (bit-exact)", torch.equal(got, ref))

    # 10. the s8 GEMM
    m, k, n = SHAPES["gemm"]
    a = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    bm = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    got, ref = S8.matmul_s8(a, bm), S8.matmul_s8_plain(a, bm)
    check("10 s8 GEMM vs plain (bit-exact)", torch.equal(got, ref))

    print("ALL OK" if not failures else "FAILURES: " + ", ".join(failures),
          flush=True)
    if failures:
        sys.exit(1)
    return 0


if __name__ == "__main__":
    main()
