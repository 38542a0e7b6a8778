"""host_ms.detect: ms of the host assembly of one batch
(eval.frame_detections on each frame, its copies included), host clock."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "host")
