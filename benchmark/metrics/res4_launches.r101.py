"""res4_launches.r101: the runtime's launch, copy and set calls a request
made while the host is inside the program's im_detect_2d.trunk.res4 span,
from its own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.trunk.res4", "launches")
