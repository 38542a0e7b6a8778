"""nms_rounds.2d: the program's nms_rounds counter over an image's root
spans: fixpoint rounds of nms_matrix, each a host sync, from the
program's own spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.counted(run, "nms_rounds")
