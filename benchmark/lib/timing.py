"""The clocks of the per-layer metrics.

``stage_ms`` is a frozen copy, as of the port's first benchmark, of
mv3d_tf_tpu_torch/tools/profiling.py:stage_ms without its CPU branch,
since the benchmark measures on a card alone (the device's busy time, that
file's ``device_busy``, is in lib/trace.py). Eager PyTorch launches the
same kernels for a stage called alone as inside the whole call, so a stage
is timed by CUDA events around repeated calls of it.
"""

import time

import torch


def stage_ms(fn, iters=5, warmup=1):
    """Mean ms per call of fn after warmup calls, by CUDA events around
    iters calls (the device's time, launches included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=5, warmup=1):
    """Mean ms per call of a host stage by the host's clock."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
