"""proposals_ms.detect: ms of the proposal layer for one batch of the cell
(eval.proposals -> proposals.proposal_layer_3d, greedy NMS of
ops/nms.py), CUDA events."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "proposals")
