"""res4_span_ms.r101: wall ms a request of the trunk's res4 stage (23
bottlenecks, 70 convs, issued by the host): the program's
im_detect_2d.trunk.res4 span, from its own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.trunk.res4", "wall_ms")
