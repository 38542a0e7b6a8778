"""idle_in_proposals.2d: the share of the traced stretch in which the
device is idle while the host is inside the program's
im_detect_2d.proposals span (or a span inside it), from the program's
own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.proposals", "idle_pct")
