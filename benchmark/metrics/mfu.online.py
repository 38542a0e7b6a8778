"""mfu.online: the model's FLOPs per frame times the window's frames per
second, over 989 TFLOP/s."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
