"""mfu.2d: the model's FLOPs per image (from the configuration's shapes)
times the window's images per second, over 989 TFLOP/s."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
