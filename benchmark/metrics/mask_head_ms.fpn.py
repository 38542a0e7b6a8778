"""mask_head_ms.fpn: device ms a request of the mask stage after the
host's class step (the detections' copy in, RoIAlign at 14x14, the four
convs, the deconv and the predictor, the probabilities' copy out): the
device time of what the program's im_mask_2d span launched, from its own
spans (lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.span(run, "im_mask_2d", "device_ms")
