"""mfu.fpn: the model's FLOPs per image (trunk through res5, the pyramid,
the RPN over five levels, the box head on every post-NMS slot, the mask
head at the window's own detections a call; lib/flops_fpn.py) times the
window's images per second, over 989 TFLOP/s."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
