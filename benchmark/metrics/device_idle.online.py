"""device_idle.online: the share of the traced requests' window in which
the device ran nothing, from torch.profiler."""

from benchmark.lib import readers


def read(run):
    return readers.idle_pct(run)
