"""res5_head_mfu.r101: res5's FLOPs a request (post-NMS slots x 1.464
GFLOP, lib/flops_r101.py) over the device time of the program's
im_detect_2d.head.res5 span, as a share of the card's dense bfloat16
peak, %."""

from benchmark.lib import roofline as R
from benchmark.lib import spans


def read(run):
    ms = spans.span(run, "im_detect_2d.head.res5", "device_ms")
    if not ms:
        return None
    return 100.0 * run.driver.res5_flops() / (ms * 1e-3) / R.PEAK_BF16_FLOPS
