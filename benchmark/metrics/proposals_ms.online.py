"""proposals_ms.online: ms of the proposal layer for one frame
(eval.proposals, greedy NMS at B=1), CUDA events."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "proposals")
