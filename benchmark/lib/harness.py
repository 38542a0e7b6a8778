"""What every cell's run shares: finding the cell's files by name, the
closed-loop window, the traced stretch, the per-layer readers, the check of
loaded modules, and the result line.

A cell is an entry of BENCHMARK.json's "workloads". Its files:
  * benchmark/workloads/<cell>.json: the driver and the limits of the
    numbers its comparison reads;
  * benchmark/configs/<config>.json: the model's sizes and test settings;
  * benchmark/traffic/<traffic>.json: the traffic's parameters;
  * benchmark/drivers/<driver>.py: a ``Driver`` class (see drivers/base.py);
  * benchmark/metrics/<metric>.py: one ``read(run)`` per per-layer metric.
"""

import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

from benchmark.lib import trace as T

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "mv3d_tf_tpu")
TRACE_CALLS = 3


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name):
    """(cell entry of BENCHMARK.json, its workload file, config, traffic,
    end-to-end metric names, per-layer metric names, {metric: unit}) for
    the cell."""
    spec = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit("unknown workload %r" % name)
    cell = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = load_json(ROOT, config["file"])
    work = load_json(BENCH, "workloads", name + ".json")
    traffic = load_json(BENCH, "traffic", cell["traffic"] + ".json")

    def mine(m):
        return name in m.get("workloads", [name])
    e2e = [m["name"] for m in spec["end_to_end"] if mine(m)]
    per_layer = [m["name"] for m in spec["per_layer"] if mine(m)]
    units = {m["name"]: m["unit"]
             for m in spec["end_to_end"] + spec["per_layer"]}
    return cell, work, cfg, traffic, e2e, per_layer, units


def driver_class(name):
    return importlib.import_module("benchmark.drivers." + name).Driver


def metric_reader(name):
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def closed_loop(call, seconds):
    """Calls back to back until ``seconds`` have passed; the window ends
    with the call that crosses it. call(i) returns the items it finished.
    Returns {"seconds", "calls", "items", "latencies_s"}."""
    lat, items, i = [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        items += call(i)
        te = time.perf_counter()
        lat.append(te - ts)
        i += 1
        if te - t0 >= seconds:
            break
    return {"seconds": te - t0, "calls": i, "items": items,
            "latencies_s": lat}


def end_to_end(window, items_name):
    """The end-to-end numbers one window gives."""
    lat_ms = [x * 1e3 for x in window["latencies_s"]]
    q = statistics.quantiles(lat_ms, n=100, method="inclusive") \
        if len(lat_ms) > 1 else lat_ms * 99
    return {items_name: window["items"] / window["seconds"],
            "latency_p50_ms": statistics.median(lat_ms),
            "latency_p95_ms": q[94]}


class Run:
    """What a traced run hands the per-layer readers."""

    def __init__(self, driver, window):
        self.driver, self.window = driver, window
        self.stage_cache = {}
        self._profile = False

    @property
    def profile(self):
        """The trace of TRACE_CALLS whole calls (lib/trace.profile), taken
        once, after the stages the readers asked for before it."""
        if self._profile is False:
            self._profile = T.profile(lambda: self.driver.call(0),
                                      TRACE_CALLS)
        return self._profile

    def items_per_s(self):
        return self.window["items"] / self.window["seconds"]

    def stage(self, name):
        """A driver's stage reading {"ms", ...}, measured once; None when
        the driver has no such stage."""
        if name not in self.stage_cache:
            stages = self.driver.stages()
            self.stage_cache[name] = (stages[name]() if name in stages
                                      else None)
        return self.stage_cache[name]

    def stage_ms(self, name):
        s = self.stage(name)
        return None if s is None else s["ms"]

    def idle_pct(self):
        p = self.profile
        return None if not p else 100.0 * (1 - p["busy_s"] / p["window_s"])


def device_info(count):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(d)
                                         for d in range(count)))}


def run_cell(name, seed, seconds, traced, device="cuda", t_start=None,
             cell_files=None):
    """One run of one cell: set-up, the window, the traced readings when
    asked, the comparison with the reference. Returns the result dict; its
    "checks" come last. cell_files, as load_cell returns them, stand in for
    the files (the tests use small shapes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, work, cfg, traffic, e2e, per_layer, units = (
        cell_files or load_cell(name))
    drv = driver_class(work["driver"])(cfg, traffic, seed, device)
    t_window = time.perf_counter()
    window = closed_loop(drv.call, seconds)
    metrics, breakdown, extra = {}, None, {}
    if traced:
        run = Run(drv, window)
        for m in per_layer:
            v = metric_reader(m)(run)
            if v is not None:
                metrics[m] = {"value": float(v), "unit": units[m]}
        if run.profile:
            extra = {"busy_s": run.profile["busy_s"],
                     "window_s": run.profile["window_s"]}
            breakdown = {k: run.profile[k]
                         for k in ("device_ops", "idle_gaps")}
    else:
        nums = end_to_end(window, drv.ITEMS_METRIC)
        nums["setup_s"] = t_window - t_start
        for m in e2e:
            metrics[m] = {"value": float(nums[m]), "unit": units[m]}
    info = (device_info(cell.get("chips", 1)) if device == "cuda" else
            {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0})
    info.update(extra)
    drv.release()
    readings = drv.judge()
    checks = {k: {"value": v, "limit": work["limits"][k]}
              for k, v in readings.items()}
    correct = bool(readings) and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": window["items"], "failed": 0,
           "metrics": metrics, "device": info}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def report(result):
    """The comparison's numbers on standard error, each beside its limit,
    then the result as the last line of standard output."""
    stream_out, stream_err = sys.stdout, sys.stderr
    for k, c in result["checks"].items():
        print("check %s %r limit %r %s" % (
            k, c["value"], c["limit"],
            "ok" if c["value"] <= c["limit"] else "FAILED"), file=stream_err)
    stream_err.flush()
    print(json.dumps(result), file=stream_out)
    stream_out.flush()
