"""trunks_ms.detect: ms of both VGG16 trunks for one batch of the cell
(models/mv3d.extract_features with the fused stem, csrc/stem_s2d.cu),
CUDA events."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "trunks")
