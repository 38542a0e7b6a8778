"""roi_align_roofline.fpn: the RoIAlign kernel's share of its roofline
(csrc/roi_align.cu; the box pass, 1000 rois at 7x7, and the mask pass, the
detections at 14x14, over P2-P5's 256 channels): the bytes both launches
need (each touched cell read once, the pooled maps written once;
lib/flops_fpn.roi_align_bytes) at 3.35 TB/s, over the device time of the
program's im_detect_2d.roi_align and im_mask_2d.roi_align spans inside the
whole request (lib/spans.py), %."""

from benchmark.lib import roofline as R
from benchmark.lib import spans


def read(run):
    box = spans.span(run, "im_detect_2d.roi_align", "device_ms")
    mask = spans.span(run, "im_mask_2d.roi_align", "device_ms")
    if not box or not mask:
        return None
    return 100.0 * R.bound(run.driver.roi_align_bytes(),
                           R.PEAK_BF16_FLOPS) / (box + mask)
