"""proposals_launches.online: the runtime's launch, copy and set calls made
while the host is inside the program's detect.proposals span, a request,
from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "detect.proposals", "launches")
