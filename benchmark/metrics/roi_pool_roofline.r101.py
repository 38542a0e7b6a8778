"""roi_pool_roofline.r101: the ROI pool kernel's share of its roofline at
14x14 over res4 (csrc/roi_pool.cu, 1000 rois at 1/16 on 1024 channels):
the bytes the rois need (each covered cell read once, the pooled maps
written once; lib/flops_r101.roi_pool_bytes) at 3.35 TB/s, over the device
time of the program's im_detect_2d.roi_pool span inside the whole request
(lib/spans.py), %."""

from benchmark.lib import roofline as R
from benchmark.lib import spans


def read(run):
    ms = spans.span(run, "im_detect_2d.roi_pool", "device_ms")
    if not ms:
        return None
    return 100.0 * R.bound([(run.driver.roi_pool_bytes(), 0)],
                           R.PEAK_BF16_FLOPS) / ms
