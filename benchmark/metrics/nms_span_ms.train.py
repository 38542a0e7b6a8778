"""nms_span_ms.train: ms of the proposal layer's NMS a training step: the
wall time of the program's detect.proposals.nms span, from the program's
own spans (lib/spans.py). Nothing encloses the span in a train step, so it
is a root there, read as it is.

What the wall holds depends on the route the layer takes. On the blocked
scan (ops/nms.nms_blocked) every fixpoint round ends in a host sync, and
the first one also waits for the forward's device work queued before the
span: the reading is the host loop plus that wait. On the greedy kernel
(csrc/nms.cu) the span holds the two launches and no sync: the reading is
the host's time to issue them."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "detect.proposals.nms", "wall_ms")
