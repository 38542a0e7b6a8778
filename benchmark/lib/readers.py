"""The arithmetic of the per-layer readers in benchmark/metrics/. Each
returns None where the run has nothing to read, never 0 for a share."""

from benchmark.lib import roofline as R


def stage_ms(run, stage):
    """The stage's ms per call of the cell, by CUDA events (host stages by
    the host's clock)."""
    return run.stage_ms(stage)


def roofline_pct(run, stage, peak=R.PEAK_BF16_FLOPS):
    """The stage's least time on the card over its measured time, %."""
    s = run.stage(stage)
    if s is None or not s.get("work") or s["ms"] <= 0:
        return None
    return 100.0 * R.bound(s["work"], peak) / s["ms"]


def idle_pct(run):
    """The share of the traced calls' window in which no operation ran on
    the device, %."""
    return run.idle_pct()


def mfu_pct(run, peak=R.PEAK_BF16_FLOPS):
    """The model's operations per item, counted from the configuration's
    shapes, times the items per second of the run's untraced window, over
    the card's dense bfloat16 peak, %."""
    return 100.0 * run.driver.flops_per_item() * run.items_per_s() / peak
