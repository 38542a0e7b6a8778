"""copy_in_ms.detect: device ms of the host-to-device copies launched
inside the program's detect.inputs span (the batch's rasters and
images), a call, from the program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "detect.inputs", "htod_ms")
