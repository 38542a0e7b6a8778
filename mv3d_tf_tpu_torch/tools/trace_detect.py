"""A torch.profiler trace of the batched detector and its top-op table; the
counterpart of tools/trace_detect.py.

    python -m mv3d_tf_tpu_torch.tools.trace_detect [--batch 8] [--steps 10] \\
        [--dtype bf16|f32] [--stem s2d_fused] [--int8 [--int8-head] \\
        [--int8-rpn]] [--pre-nms N] [--nms auto|blocked_fixed] \\
        [--out DIR] [--top 25] [--parse-only] [--device cuda|cpu]

Builds eval.build_detect_batch_fn with the given flags at the reference
shapes (601x601x9 BEV, 384x1248 image; He-scaled weights and inputs from
seed 0), warms it, records --steps calls (each ending in a synchronize)
with torch.profiler's CPU and CUDA activities, exports the Chrome trace
to <out>/trace.json and parses it (``parse_trace``): the top device
kernels by total time, every hand kernel of csrc/ that ran, and the
device's idle gaps. The JAX tool parses a jax.profiler perfetto trace of
one fused XLA program (tools/trace_detect.py:33-83); here the exported
trace's kernel events are the device's own, so no lane filtering is
needed. On the CPU (--device cpu) the table holds the top-level host ops
instead, and no device time is measured.
"""

import argparse
import collections
import json
import os
import os.path as osp
import re
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name):
    """A kernel's or op's name without its return type, namespaces,
    template arguments' bodies and parameter list: the table's label."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^void\s+", "", name).split("(")[0]
    return name.strip() or "?"


def function_of(name):
    """A short name's function: template arguments and namespaces off."""
    return name.split("<")[0].split("::")[-1]


def _top_level(events):
    """The events not nested in another of the same thread (host ops)."""
    out = []
    ends = {}
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        lane = (e.get("pid"), e.get("tid"))
        if e["ts"] >= ends.get(lane, float("-inf")):
            out.append(e)
            ends[lane] = e["ts"] + e["dur"]
    return out


def _union(intervals):
    """Busy time and the gaps between the union's pieces, in us."""
    busy, gaps, end = 0.0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s - end))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def parse_trace(path, top=25, steps=1, log=print):
    """Aggregate an exported torch.profiler Chrome trace: the device
    kernels (categories kernel, gpu_memcpy, gpu_memset) when it has any,
    else the top-level host ops. Prints the lane's total, the top ops by
    total time (ms per step, share, calls), every hand kernel of csrc/ that
    ran, and the idle gaps (the union of the lane's intervals against its
    span). Returns {"lane", "total_ms", "busy_ms", "span_ms",
    "idle_share", "ops": [(name, ms, calls)], "hand": {name: (ms, calls)},
    "gaps": [(at_ms, ms)]}, times summed over the trace."""
    from mv3d_tf_tpu_torch.kernels import kernel_symbols
    with open(path) as f:
        data = json.load(f)
    events = [e for e in data.get("traceEvents", data) if e.get("ph") == "X"
              and "dur" in e]
    lane = "device"
    chosen = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not chosen:
        lane = "host"
        chosen = _top_level([e for e in events if e.get("cat") == "cpu_op"])
    by_name, counts = collections.Counter(), collections.Counter()
    for e in chosen:
        name = short_name(e.get("name", "?"))
        by_name[name] += float(e["dur"])
        counts[name] += 1
    total = sum(by_name.values())
    busy, gaps = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in chosen])
    t0 = min((float(e["ts"]) for e in chosen), default=0.0)
    span = max((float(e["ts"]) + float(e["dur"]) for e in chosen),
               default=0.0) - t0
    symbols = kernel_symbols()
    hand = {n: (by_name[n] / 1e3, counts[n]) for n in by_name
            if function_of(n) in symbols}
    log("{} total: {:.3f} ms over {} steps ({:.3f} ms/step), {} events, "
        "span {:.3f} ms, busy {:.3f} ms, idle share {:.3f}".format(
            lane, total / 1e3, steps, total / 1e3 / steps, len(chosen),
            span / 1e3, busy / 1e3, 1 - busy / span if span else 0.0))
    log("{:<64s} {:>9s} {:>7s} {:>6s}".format("op", "ms/step", "%", "calls"))
    for name, dur in by_name.most_common(top):
        log("{:<64s} {:9.3f} {:6.1f}% {:6d}".format(
            name[:64], dur / 1e3 / steps, 100.0 * dur / max(total, 1e-9),
            counts[name]))
    log("hand kernels (csrc/) in the trace:")
    for name, (ms, calls) in sorted(hand.items()):
        log("  {:<62s} {:9.3f} {:6d}".format(name[:62], ms / steps, calls))
    if not hand:
        log("  none")
    big = sorted(gaps, key=lambda g: -g[1])[:5]
    log("idle gaps: {} totalling {:.3f} ms; largest (at ms, ms): {}".format(
        len(gaps), sum(g for _, g in gaps) / 1e3,
        ", ".join("({:.3f}, {:.3f})".format((at - t0) / 1e3, g / 1e3)
                  for at, g in big)))
    return {"lane": lane, "total_ms": total / 1e3, "busy_ms": busy / 1e3,
            "span_ms": span / 1e3,
            "idle_share": 1 - busy / span if span else 0.0,
            "ops": [(n, d / 1e3, counts[n]) for n, d in by_name.most_common()],
            "hand": hand,
            "gaps": [((at - t0) / 1e3, g / 1e3) for at, g in gaps]}


def record(run, steps, out_dir, device):
    """run() --steps times under torch.profiler (each call ends in a
    synchronize); writes <out_dir>/trace.json. Returns (path, ms per call
    on the host clock)."""
    import torch

    from mv3d_tf_tpu_torch.tools import profiling as P
    os.makedirs(out_dir, exist_ok=True)
    path = osp.join(out_dir, "trace.json")
    with torch.profiler.profile(activities=P.activities(device)) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
            P.sync(device)
        dt = (time.perf_counter() - t0) / steps
    prof.export_chrome_trace(path)
    return path, dt * 1e3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Trace the batched detector")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                    help="the float detector's compute dtype")
    ap.add_argument("--stem", default=None,
                    help="stem_impl: the float detector's (literal, fused, "
                         "s2d, s2d_fused) or, with --int8, the int8 one's "
                         "(bf16, s2d, s2d_int8); default the detector's")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 PTQ detector, calibrated on 2 frames")
    ap.add_argument("--int8-head", action="store_true")
    ap.add_argument("--int8-rpn", action="store_true")
    ap.add_argument("--pre-nms", type=int, default=None,
                    help="pre-NMS top-K (default 6000)")
    ap.add_argument("--nms", default="auto",
                    choices=["auto", "blocked_fixed"])
    ap.add_argument("--out", default=osp.join("output", "trace_detect"))
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--parse-only", action="store_true",
                    help="parse <out>/trace.json again")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    path = osp.join(args.out, "trace.json")
    if args.parse_only:
        return parse_trace(path, top=args.top, steps=args.steps)

    import torch

    from mv3d_tf_tpu_torch import quant as Q
    from mv3d_tf_tpu_torch.eval import PIXEL_MEANS, build_detect_batch_fn
    from mv3d_tf_tpu_torch.tools import profiling as P

    device = torch.device(args.device)
    B = args.batch
    print("device:", P.device_name(device), "stem:", args.stem, "batch:", B,
          "int8:", args.int8, flush=True)
    params = P.he_params(device)
    bev, image, calib = P.detector_inputs(B, device)
    qstate = None
    if args.int8:
        img_ms = image - torch.from_numpy(PIXEL_MEANS).to(device)
        pool_bv = pool_img = None
        if args.int8_head:
            pool_bv, pool_img = Q.calibrate_pooled_features(
                params, bev, img_ms, calib, *P.feat_hw())
        qstate = Q.build_quant_state(params, bev[:2], img_ms[:2],
                                     pooled_bv=pool_bv, pooled_img=pool_img)
    feat_h, feat_w = P.feat_hw()
    detect = build_detect_batch_fn(
        feat_h=feat_h, feat_w=feat_w, quant=qstate, stem_impl=args.stem,
        nms_impl=args.nms, quant_rpn=args.int8_rpn,
        pre_nms_top_n=args.pre_nms or 6000,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None)

    def run():
        return detect(params, bev, image, calib)

    t0 = time.perf_counter()
    run()
    P.sync(device)
    print("first call: {:.1f}s".format(time.perf_counter() - t0))
    for _ in range(2):
        run()
    path, ms = record(run, args.steps, args.out, device)
    print("traced {} steps at {:.1f} ms/batch -> {:.2f} frames/s; trace {}"
          .format(args.steps, ms, B * 1e3 / ms, path), flush=True)
    return parse_trace(path, top=args.top, steps=args.steps)


if __name__ == "__main__":
    main()
