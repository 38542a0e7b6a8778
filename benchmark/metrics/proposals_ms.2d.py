"""proposals_ms.2d: ms of the 2D proposal layer for one image
(faster_rcnn_2d.proposal_layer_2d with ops/nms.nms_matrix), CUDA events."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "proposals")
