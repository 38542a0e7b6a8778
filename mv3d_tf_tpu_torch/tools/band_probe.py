"""Probe of the bf16 row-sharded trunk (parallel/mesh.build_spatial_detect):
is the difference between a band's conv rows and the whole frame's only a
convolution's rounding?

    python -m mv3d_tf_tpu_torch.tools.band_probe [--ranks 2] [--seed 0] \\
        [--rows 601] [--device cuda|cpu]

One frame (a 601x601x9 BEV and a 384x1248x3 image at the defaults; --rows
cuts both views' height) from He weights (utils.weights.he_normal_params).
Each view runs the bf16 trunk on the whole frame, the stem through the
literal stem's kernel as the row-sharded detector runs it. Then, per conv
layer from conv2_1 on, the layer's whole-frame bf16 input is convolved three
ways (bias, no ReLU): whole in bf16; per band of mesh.row_bands, on the rows
of that input that mesh.band_slice gives the band, in bf16; and whole in
float32 (no TF32) on the same bf16 inputs and weights. The band's rows that
see no cut edge are compared with the whole frame's, and both with the
float32 result, in bf16 ulps of each output channel's largest float32
value. Prints a JSON line per view and layer, then the summary as the last
line.
"""

import argparse
import json
import sys

import numpy as np


def bf16_ulp(ref):
    """The bf16 spacing at each |ref|: 2^(e - 8) for |ref| = m 2^e, m in
    [0.5, 1)."""
    import torch
    _, e = torch.frexp(ref)
    return torch.ldexp(torch.ones_like(ref), e - 8)


def layer_probe(x, w, b, bands, ref_of):
    """One conv layer on its whole-frame bf16 input x (1,H,W,C): returns
    the record of the band rows against the whole frame and of both
    against ref_of(x) (float32), in bf16 ulps of each output channel's
    largest |ref|. (An element's own ulp is no unit where its 9*C products
    cancel to far below their sum of magnitudes: there float32
    accumulation alone is off by many of its ulps.)"""
    import torch

    from mv3d_tf_tpu_torch.models.vgg import conv2d
    whole = conv2d(x, w, b, relu=False, dtype=torch.bfloat16).float()
    ref = ref_of(x)
    ulp = bf16_ulp(ref.abs().amax(dim=(0, 1, 2)))
    rec = {"rows": 0, "differ": 0,
           "whole_ulps": float(((whole - ref).abs() / ulp).max()),
           "band_ulps": 0.0, "band_vs_whole_ulps": 0.0}
    h = x.shape[1]
    for lo, hi in bands:
        y = conv2d(x[:, lo:hi], w, b, relu=False,
                   dtype=torch.bfloat16).float()
        a = 1 if lo > 0 else 0            # a cut edge's row sees padding
        z = y.shape[1] - (1 if hi < h else 0)
        y, rows = y[:, a:z], slice(lo + a, lo + z)
        rec["rows"] += z - a
        rec["differ"] += int((y != whole[:, rows]).sum())
        rec["band_ulps"] = max(rec["band_ulps"], float(
            ((y - ref[:, rows]).abs() / ulp).max()))
        rec["band_vs_whole_ulps"] = max(rec["band_vs_whole_ulps"], float(
            ((y - whole[:, rows]).abs() / ulp).max()))
    return rec


def view_probe(params, x, suffix, ranks):
    """Every conv layer from conv2_1 on of one view's trunk; yields
    (layer, record)."""
    import torch
    import torch.nn.functional as F

    from mv3d_tf_tpu_torch.models.vgg import (VGG_LAYERS, conv2d,
                                              f32_convs_without_tf32, layer,
                                              max_pool_2x2_valid, stem_apply)
    from mv3d_tf_tpu_torch.parallel import mesh as PM

    h_in = x.shape[1]
    bands_in = [PM.band_slice(band, h_in)
                for band in PM.row_bands(PM.feature_rows(h_in), ranks)]
    x = stem_apply("fused", x, *layer(params, "conv1_1" + suffix),
                   *layer(params, "conv1_2" + suffix), dtype=torch.bfloat16)
    stride = 2
    if x.is_cuda:
        f32_convs_without_tf32()
    for name, _, pool in VGG_LAYERS[2:]:
        w, b = layer(params, name + suffix)
        wb, bb = w.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()

        def ref_of(xb):
            return F.conv2d(xb.float().permute(0, 3, 1, 2), wb, bb,
                            padding=1).permute(0, 2, 3, 1)
        # a band's input rows at this layer: start / stride, and its length
        # halved (floor) by each pool so far
        bands = []
        for start, stop in bands_in:
            n = stop - start
            for _ in range(stride.bit_length() - 1):
                n //= 2
            bands.append((start // stride, start // stride + n))
        yield name, layer_probe(x, w, b, bands, ref_of)
        x = conv2d(x, w, b, dtype=torch.bfloat16)
        if pool:
            x = max_pool_2x2_valid(x)
            stride *= 2


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", type=int, default=None,
                        help="cut both views to this many rows")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from mv3d_tf_tpu_torch.eval import PIXEL_MEANS
    from mv3d_tf_tpu_torch.utils.weights import (he_normal_params,
                                                 params_from_jax)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("band_probe: no CUDA device (--device cpu runs the "
                         "plain stem on the CPU)")
    params = params_from_jax(he_normal_params(args.seed), device=args.device)
    rng = np.random.RandomState(args.seed)
    bev = rng.rand(1, 601, 601, 9).astype(np.float32)
    image = (rng.rand(1, 384, 1248, 3) * 255).astype(np.float32) - PIXEL_MEANS
    summary = {"ranks": args.ranks, "layers": 0, "first_differing": None,
               "max_whole_ulps": 0.0, "max_band_ulps": 0.0,
               "max_band_vs_whole_ulps": 0.0}
    with torch.inference_mode():
        for view, suffix, x in (("bev", "", bev), ("image", "_2", image)):
            x = torch.from_numpy(x[:, :args.rows]).to(args.device)
            for name, rec in view_probe(params, x, suffix, args.ranks):
                print(json.dumps(dict(view=view, layer=name, **rec)))
                summary["layers"] += 1
                if rec["differ"] and summary["first_differing"] is None:
                    summary["first_differing"] = "%s %s" % (view, name)
                for k in ("whole", "band", "band_vs_whole"):
                    summary["max_%s_ulps" % k] = max(
                        summary["max_%s_ulps" % k], rec["%s_ulps" % k])
    summary["within_one_ulp"] = max(summary["max_whole_ulps"],
                                    summary["max_band_ulps"]) <= 1.0
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
