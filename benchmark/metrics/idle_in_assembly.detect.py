"""idle_in_assembly.detect: the share of the traced stretch in which the
device is idle while the host is inside the program's assembly spans
(eval.frame_detections), from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "assembly", "idle_pct")
