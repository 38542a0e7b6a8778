"""fpn_ms.fpn: device ms a request of the feature pyramid (the laterals,
the top-down sums, the 3x3 outputs and P6 over C2-C5, one CUDA graph): the
device time of what the program's im_detect_2d.fpn span launched, from its
own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.fpn", "device_ms")
