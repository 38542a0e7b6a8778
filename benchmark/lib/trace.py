"""A torch.profiler trace of a few of the window's calls, reduced to the
device's busy time, its window, and the breakdown of the result line: the
device operations that took most time and the idle gaps by what the host
was doing meanwhile.

``short_name`` and ``union`` are frozen copies, as of the port's first
benchmark, of mv3d_tf_tpu_torch/tools/trace_detect.py:short_name and
:_union (there on an exported Chrome trace; here on the profiler's own
events, which need no file), and the busy time is
mv3d_tf_tpu_torch/tools/profiling.py:device_busy's: the union of the
device's intervals against the span from the first event to the last.
"""

import bisect
import collections
import re

import torch

TOP = 10
IDLE = "host outside any op"


def short_name(name):
    """A kernel's or op's name without its return type, namespaces,
    template arguments' bodies and parameter list."""
    name = re.sub(r"\(anonymous namespace\)::", "", name)
    name = re.sub(r"^void\s+", "", name).split("(")[0]
    return name.strip() or "?"


def union(intervals):
    """Busy time and the gaps between the union's pieces: (busy, [(start,
    length)])."""
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


def _host_at(starts, host, t):
    """The innermost host op running at time t (the latest-starting one
    that contains it, among the last few that started before it)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 65, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return IDLE


def profile(fn, calls):
    """Run fn() ``calls`` times under torch.profiler (CPU and CUDA) and
    reduce the trace: {"busy_s", "window_s", "device_ops", "idle_gaps"},
    None when the trace holds no device operation."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    host = sorted((e.time_range.start, e.time_range.end, short_name(e.name))
                  for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU)
    busy, gaps = union([(e.time_range.start, e.time_range.end) for e in dev])
    start = min(e.time_range.start for e in events)
    end = max(e.time_range.end for e in events)
    ops = collections.Counter()
    for e in dev:
        ops[short_name(e.name)] += e.time_range.end - e.time_range.start
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for s, length in gaps:
        idle[_host_at(starts, host, s + length / 2)] += length
    # the stretches before the first and after the last device operation
    first = min(e.time_range.start for e in dev)
    last = max(e.time_range.end for e in dev)
    idle["before the first device op"] += first - start
    idle["after the last device op"] += end - last
    return {"busy_s": busy / 1e6, "window_s": (end - start) / 1e6,
            "device_ops": [[n, t / 1e6] for n, t in ops.most_common(TOP)],
            "idle_gaps": [[n, t / 1e6] for n, t in idle.most_common(TOP)
                          if t > 0]}
