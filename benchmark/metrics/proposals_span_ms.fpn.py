"""proposals_span_ms.fpn: ms of the per-level proposal layer a request
(the top 1000 of each of five levels, decode and clip, the five levels'
NMS in one call, the best 1000 over them), inside the whole request: the
wall time of the program's im_detect_2d.proposals span, from its own spans
(lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.proposals", "wall_ms")
