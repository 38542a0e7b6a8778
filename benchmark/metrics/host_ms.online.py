"""host_ms.online: ms of the host assembly of one frame
(eval.frame_detections, its copies included), host clock."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "host")
