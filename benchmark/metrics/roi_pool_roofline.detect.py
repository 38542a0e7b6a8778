"""roi_pool_roofline.detect: the ROI pool kernel's share of its roofline
over both views of one batch (ops/roi_pool.roi_pool_fast,
csrc/roi_pool.cu): the least time of the bytes its rois need over the
CUDA-event time of the two calls."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "roi_pool")
