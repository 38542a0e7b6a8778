"""proposals_span_ms.online: ms of the proposal layer a request where it
runs, inside the whole request: the wall time of the program's
detect.proposals span, from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "detect.proposals", "wall_ms")
