"""device_idle.fpn: the share of the traced requests' window in which the
device ran nothing (the host's class step between the two device stages
included), from torch.profiler."""

from benchmark.lib import readers


def read(run):
    return readers.idle_pct(run)
