"""proposals_span_ms.detect: ms of the proposal layer a call where it runs,
inside the whole call: the wall time of the program's detect.proposals
span, from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "detect.proposals", "wall_ms")
