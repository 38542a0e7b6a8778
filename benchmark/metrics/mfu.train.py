"""mfu.train: a train step's FLOPs (three times the forward's over both
trunks, the RPN and the fusion head on the sampled rois, from the
configuration's shapes) times the window's steps per second, over 989
TFLOP/s."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
