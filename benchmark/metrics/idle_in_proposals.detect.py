"""idle_in_proposals.detect: the share of the traced stretch in which the
device is idle while the host is inside the program's detect.proposals
span (or a span inside it), from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "detect.proposals", "idle_pct")
