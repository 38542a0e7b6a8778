"""The FLOP counter of the mfu readers against sums written out by hand."""

from benchmark.lib import harness as H
from benchmark.lib import roofline as R


def _vgg16_by_hand(h, w, cin, pools):
    # 2 * H * W * Cin * Cout * 9 per conv, the map halved after each pool
    total = 0
    plan = [(cin, 64), (64, 64), "p", (64, 128), (128, 128), "p",
            (128, 256), (256, 256), (256, 256), "p", (256, 512), (512, 512),
            (512, 512), "p4", (512, 512), (512, 512), (512, 512)]
    for step in plan:
        if step == "p" or (step == "p4" and pools == 4):
            h, w = h // 2, w // 2
        elif isinstance(step, tuple):
            total += 2 * h * w * step[0] * step[1] * 9
    return total, h, w


def test_mv3d_frame_by_hand():
    cfg = H.load_json(H.ROOT, "benchmark/configs/mv3d_kitti_vgg16.json")
    bev, h, w = _vgg16_by_hand(601, 601, 9, 3)
    img, _, _ = _vgg16_by_hand(384, 1248, 3, 3)
    assert (h, w) == (75, 75)
    rpn = 2 * 75 * 75 * 512 * (512 * 9 + 8 + 24)
    fc6, fc7, heads = 25088 * 2048, 2048 * 2048, 4096 * (2 + 48)
    head = 2 * 300 * (2 * fc6 + 2 * fc7 + heads)
    assert R.mv3d_frame_flops(cfg) == bev + img + rpn + head
    assert 7.0e11 < R.mv3d_frame_flops(cfg) < 8.0e11


def test_frcnn_image_by_hand():
    cfg = H.load_json(H.ROOT, "benchmark/configs/faster_rcnn_vgg16_voc.json")
    trunk, h, w = _vgg16_by_hand(608, 1024, 3, 4)
    assert (h, w) == (38, 64)
    rpn = 2 * 38 * 64 * 512 * (512 * 9 + 18 + 36)
    head = 2 * 300 * (25088 * 4096 + 4096 * 4096 + 4096 * (21 + 84))
    assert R.frcnn_image_flops(cfg) == trunk + rpn + head


def test_bound_takes_the_larger_side_per_launch():
    # 3.35 GB at 3.35 TB/s is 1 ms; 989 GFLOP at 989 TFLOP/s is 1 ms
    parts = [(3.35e9, 0.0), (0.0, 989e9 * 2), (3.35e9, 989e9)]
    assert abs(R.bound(parts, R.PEAK_BF16_FLOPS) - 4.0) < 1e-9
