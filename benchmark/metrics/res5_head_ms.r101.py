"""res5_head_ms.r101: device ms a request of res5 run per RoI (the 1000
post-NMS slots through res5's three bottlenecks and the mean): the device
time of what the program's im_detect_2d.head.res5 span launched, from its
own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_detect_2d.head.res5", "device_ms")
