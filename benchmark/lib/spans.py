"""The program's own spans and counters (mv3d_tf_tpu_torch/trace.py) over a
few whole calls, reduced per span name.

``reading(run)``, on its first use in a traced run and cached on the run,
turns the program's tracing on, makes WALL_CALLS whole calls of the driver
as they are, then harness.TRACE_CALLS under torch.profiler (CPU and CUDA),
turns tracing off and reduces both. A program without trace.py gives None,
and so do the readers of it. Per span name and per driver call:
  * wall ms (``walls``): the span's duration in the calls made without the
    profiler, on the program's clock (its records), the median over the
    calls: the host's pace swings by 2x within seconds on the card's
    machine. Under the profiler a launch costs the host several us more,
    and a layer of 10,000 launches reads twice its time, so the profiled
    duration is kept apart ("traced_ms");
  * counter deltas: the program's counters over the span;
  * from the profiled calls (``reduce``), on the profiler's clock:
    launches, the runtime's launch, copy and set calls (LAUNCHES) whose
    start on the host lies inside the span; device ms of what it launched,
    and the host-to-device copies' part of it, each device operation
    joined to the runtime call that launched it by the profiler's
    correlation id, not by time; the idle share, the share of the traced
    stretch in which the device ran nothing and the innermost span at the
    gap's midpoint (lib/trace.py's rule for ops) is this span or one
    inside it (gaps in no span go to NO_SPAN); and the hand kernels'
    launches as the counters count them beside their events in the trace.
The stretch and the gaps are lib/trace.py's: from the first event to the
last, the union of the device's operations against it. On the CPU (the
tests' small runs) the operations run on the host: the host's ops stand in
for the device's.
"""

import bisect
import collections
import importlib.util
import statistics
import time

import torch

from benchmark.lib import harness as H
from benchmark.lib.trace import short_name, union

NO_SPAN = "no span"
LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
            "cuMemset", "cudaGraphLaunch")
COUNTERS = ("host_syncs", "nms_rounds")   # the rest count hand-kernel launches
WALL_CALLS = 11


def reading(run):
    """``record`` of the driver's calls, taken once a run; None when the
    program has no spans."""
    if "_spans" not in vars(run):
        run._spans = record(run.driver.call, run.driver.device)
    return run._spans


def span(run, name, key):
    """``key`` of span ``name`` in the run's reading; None where the run has
    no such span."""
    r = reading(run)
    s = None if r is None else r["spans"].get(name)
    return None if s is None else s.get(key)


def counted(run, counter):
    """A program counter's change over a call's root spans."""
    r = reading(run)
    return None if r is None else r["counts"].get(counter)


def record(call, device, calls=H.TRACE_CALLS, wall_calls=WALL_CALLS):
    """call(0) ``wall_calls`` times with the program's tracing on, then
    ``calls`` times under torch.profiler too; ``reduce`` of the profiled
    calls with ``walls`` of the others and their median "call_ms" (host
    clock)."""
    if importlib.util.find_spec("mv3d_tf_tpu_torch.trace") is None:
        return None
    from mv3d_tf_tpu_torch import trace
    from mv3d_tf_tpu_torch.kernels import kernel_symbols
    on_card = device != "cpu"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    trace.clear()
    call_ns, plain = [], []
    with trace.tracing():
        for _ in range(wall_calls):
            t0 = time.perf_counter_ns()
            call(0)
            call_ns.append(time.perf_counter_ns() - t0)
            plain.append(trace.records())
            trace.clear()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                call(0)
            if on_card:
                torch.cuda.synchronize()
    traced = trace.records()
    trace.clear()
    out = reduce(*events(prof.profiler.kineto_results.events(),
                         {r.name for r in traced}, on_card),
                 traced, calls, hand=kernel_symbols())
    w = walls(plain)
    for name, v in w["spans"].items():
        out["spans"].setdefault(name, {}).update(v)
    out["counts"] = w["counts"]
    out["roots_ms"] = w["roots_ms"]
    out["call_ms"] = statistics.median(call_ns) / 1e6
    return out


def walls(per_call):
    """Per span name, from the program's records of each call (a list of
    trace.Span lists: name, id, parent, start_ns, end_ns, counts), the
    median over the calls of the call's sums: {"spans": {name: {"n",
    "wall_ms", "self_ms" (less its children's), "counts"}}, "counts" (each
    counter over the root spans), "roots_ms"}."""
    rows = []
    for records in per_call:
        row = collections.defaultdict(float)
        names = {r.id: r.name for r in records}
        for r in records:
            ns = r.end_ns - r.start_ns
            row[r.name, "n"] += 1
            row[r.name, "wall"] += ns
            if r.parent is None:
                row[None, "wall"] += ns
            else:
                row[names[r.parent], "child"] += ns
            for k, v in r.counts.items():
                if k in COUNTERS:
                    row[r.name, k] += v
                    if r.parent is None:
                        row[None, k] += v
        rows.append(row)

    def med(name, key):
        return statistics.median(row[name, key] for row in rows)

    names = {n for row in rows for n, _ in row if n is not None}
    return {"spans": {
        n: {"n": med(n, "n"), "wall_ms": med(n, "wall") / 1e6,
            "self_ms": statistics.median(
                row[n, "wall"] - row[n, "child"] for row in rows) / 1e6,
            "counts": {k: med(n, k) for k in COUNTERS}}
        for n in names},
        "counts": {k: med(None, k) for k in COUNTERS},
        "roots_ms": med(None, "wall") / 1e6}


def events(kineto, names, on_card):
    """(spans [(start, end, name)], runtime launches [(start, end, name,
    correlation)], device operations [(start, end, name, correlation)],
    stretch (start, end)) of the profiler's kineto events, in ns. Spans are
    the host's events named in ``names`` (record_function's; the device's
    copies of them are left out); on the CPU the device operations are the
    host's ops. (Kineto events are told apart by device and name: torch
    2.11's have no activity type.)"""
    spans, runtime, dev = [], [], []
    lo, hi = float("inf"), float("-inf")
    for e in kineto:
        s = e.start_ns()
        t = s + e.duration_ns()
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name in names:
                continue
            dev.append((s, t, name, e.correlation_id()))
        elif name in names:
            spans.append((s, t, name))
        elif name.startswith(LAUNCHES):
            runtime.append((s, t, name, e.correlation_id()))
        elif not on_card:
            dev.append((s, t, name, None))
        lo, hi = min(lo, s), max(hi, t)
    return spans, runtime, dev, (lo, hi)


class _Spans:
    """Span instances nested by time (one host thread): the innermost
    instance at a time, and the names of it and its ancestors."""

    def __init__(self, spans):
        self.inst = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.inst]
        self.parent, open_ = [], []
        for i, (s, _, _) in enumerate(self.inst):
            while open_ and self.inst[open_[-1]][1] <= s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else None)
            open_.append(i)

    def at(self, t):
        """The innermost instance containing t, or None: the last to start
        before t, or the nearest of its ancestors that ends after t."""
        j = bisect.bisect_right(self.starts, t) - 1
        if j < 0:
            return None
        while j is not None and self.inst[j][1] <= t:
            j = self.parent[j]
        return j

    def chain(self, j):
        """The names of instance j and its ancestors."""
        while j is not None:
            yield self.inst[j][2]
            j = self.parent[j]


def reduce(spans, runtime, dev, stretch, records=(), calls=1, hand=()):
    """Per span name and call, in a profiled stretch: {"traced_ms",
    "launches", "device_ms", "htod_ms", "idle_pct", "idle_self_pct" (gaps
    at whose midpoint it is the innermost span), "hand_counted" (the hand
    kernels' launch counters over the span, from ``records``),
    "hand_traced" (events of the kernels ``hand`` names that it
    launched)}; with the stretch's "window_ms", "busy_ms", "idle_pct",
    NO_SPAN's "no_span_idle_pct" and "unlinked_device_ms" (device
    operations no runtime call of the trace launched). The idle_self_pct's
    and no_span_idle_pct add up to idle_pct."""
    S = _Spans(spans)
    per = collections.defaultdict(lambda: collections.defaultdict(float))
    for s, e, name in S.inst:
        per[name]["traced"] += e - s

    launched = {}
    for s, _, name, corr in runtime:
        if not name.startswith(LAUNCHES):
            continue
        j = launched[corr] = S.at(s)
        for n in S.chain(j):
            per[n]["launches"] += 1
    hand = set(hand)
    unlinked = 0
    for s, e, name, corr in dev:
        if corr not in launched:
            unlinked += e - s
            continue
        is_hand = short_name(name).split("<")[0].split("::")[-1] in hand
        for n in S.chain(launched[corr]):
            per[n]["device"] += e - s
            if "HtoD" in name:
                per[n]["htod"] += e - s
            if is_hand:
                per[n]["hand_traced"] += 1

    lo, hi = stretch
    window = hi - lo
    busy, gaps = union([(s, e) for s, e, _, _ in dev])
    # and the stretches before the first and after the last operation
    first = min((s for s, _, _, _ in dev), default=hi)
    last = max((e for _, e, _, _ in dev), default=hi)
    gaps += [(lo, first - lo), (last, hi - last)]
    idle_self = collections.Counter()
    for s, length in gaps:
        j = S.at(s + length / 2)
        idle_self[NO_SPAN if j is None else S.inst[j][2]] += length
        for n in S.chain(j):
            per[n]["idle"] += length
    for r in records:
        per[r.name]["hand_counted"] += sum(
            n for k, n in r.counts.items() if k not in COUNTERS)

    def pct(x):
        return 100.0 * x / window if window > 0 else None

    out = {name: {
        "traced_ms": v["traced"] / 1e6 / calls,
        "launches": v["launches"] / calls,
        "device_ms": v["device"] / 1e6 / calls,
        "htod_ms": v["htod"] / 1e6 / calls,
        "idle_pct": pct(v["idle"]), "idle_self_pct": pct(idle_self[name]),
        "hand_counted": v["hand_counted"] / calls,
        "hand_traced": v["hand_traced"] / calls} for name, v in per.items()}
    return {"spans": out, "window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "idle_pct": pct(window - busy),
            "no_span_idle_pct": pct(idle_self[NO_SPAN]),
            "unlinked_device_ms": unlinked / 1e6 / calls}
