"""device_idle.train: the share of the traced steps' window in which the
device ran nothing, from torch.profiler."""

from benchmark.lib import readers


def read(run):
    return readers.idle_pct(run)
