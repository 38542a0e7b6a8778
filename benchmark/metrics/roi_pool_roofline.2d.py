"""roi_pool_roofline.2d: the ROI pool kernel's share of its roofline at
1/16 for one image (ops/roi_pool.roi_pool_fast, csrc/roi_pool.cu)."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "roi_pool")
