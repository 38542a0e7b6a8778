"""proposals_span_ms.2d: ms of the 2D proposal layer an image where it
runs, inside the whole request: the wall time of the program's
im_detect_2d.proposals span, from the program's own spans
(lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.proposals", "wall_ms")
