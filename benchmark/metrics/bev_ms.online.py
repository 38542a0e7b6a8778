"""bev_ms.online: ms of the BEV front end for one scan (ops/bev.pad_points
and point_cloud_2_top_batch, csrc/bev_place.cu), the scan's copy to the
card included, CUDA events."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "bev")
