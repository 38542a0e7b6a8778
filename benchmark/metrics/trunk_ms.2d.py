"""trunk_ms.2d: ms of the stride-16 VGG16 trunk for one image
(models/vggnet.trunk_apply_2d), CUDA events."""

from benchmark.lib import readers


def read(run):
    return readers.stage_ms(run, "trunk")
