"""mfu.r101: the model's FLOPs per image (trunk, RPN, and res5 and the
heads on every post-NMS slot, from the configuration's shapes,
lib/flops_r101.py) times the window's images per second, over 989
TFLOP/s."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
