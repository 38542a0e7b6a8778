"""proposals_launches.2d: the runtime's launch, copy and set calls made
while the host is inside the program's im_detect_2d.proposals span, an
image, from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.proposals", "launches")
