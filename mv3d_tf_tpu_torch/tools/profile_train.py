"""The train step's variants, each timed on its own; the counterpart of
tools/profile_train.py.

    python -m mv3d_tf_tpu_torch.tools.profile_train [--iters 10] \\
        [--variants full small_nms plain_pool f32] [--device cuda|cpu]

Each variant builds train.build_train_step at the reference shapes
(tools/trace_train.build_step: He-scaled weights, 4 gt cars, seeded
draws), takes a warm-up step, then --iters steps ending in a synchronize
(ms/iter on the host clock), and one more step traced for its device busy
and idle shares:
  full        - the step as it ships: bf16, the ROI kernels, pre/post-NMS
                12000/2000;
  small_nms   - pre/post-NMS cut to 512/128: full minus it is the share of
                the proposal budget;
  plain_pool  - the plain ROI pool and gradient (ops/roi_pool
                .roi_pool_train_plain) in place of the two kernels: the
                counterpart of the JAX tool's xla_pool;
  f32         - float32 compute, against full's bf16.
The JAX tool diffs variants of one fused jitted step, since a stage timed
alone lies under XLA fusion; eager PyTorch has no fusion to defeat, so
each variant is a step of its own and the differences are read directly.
"""

import argparse

VARIANTS = ("full", "small_nms", "plain_pool", "f32")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Train-step variants")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import time

    import torch

    from mv3d_tf_tpu_torch.ops.roi_pool import roi_pool_train_plain
    from mv3d_tf_tpu_torch.tools import profiling as P
    from mv3d_tf_tpu_torch.tools.trace_train import build_step

    device = torch.device(args.device)
    print("device:", P.device_name(device), flush=True)
    kwargs = {"full": {}, "f32": {},
              "small_nms": {"pre_nms_top_n": 512, "post_nms_top_n": 128},
              "plain_pool": {"pool": roi_pool_train_plain}}
    ms = {}
    for name in args.variants:
        dtype = None if name == "f32" else torch.bfloat16
        run, params = build_step(device, dtype, **kwargs[name])
        t0 = time.perf_counter()
        run()
        P.sync(device)
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            m = run()
        P.sync(device)
        ms[name] = (time.perf_counter() - t0) / args.iters * 1e3
        print("{}: {:.3f} ms/iter over {} steps (first {:.1f}s), loss {:.5f}; "
              "{}".format(name, ms[name], args.iters, warm, m["loss"].item(),
                          P.busy_line(run, device)), flush=True)
        del run, params
    if "full" in ms:
        for name, what in (("small_nms", "proposal/NMS budget share"),
                           ("plain_pool", "plain pool over the kernels"),
                           ("f32", "f32 over bf16")):
            if name in ms:
                delta = (ms["full"] - ms[name] if name == "small_nms"
                         else ms[name] - ms["full"])
                print("-> {} ~ {:.3f} ms".format(what, delta))
    return ms


if __name__ == "__main__":
    main()
