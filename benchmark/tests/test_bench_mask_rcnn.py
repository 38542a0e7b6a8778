"""The cell mask_rcnn_r101_fpn.detect_b1: its files name what exists, the
Mask R-CNN R-101-FPN FLOP and byte counters against sums written out by
hand, the benchmark's copy of the reference against torch_reference/, and
at small shapes on the CPU a sound run that passes, the control that
fails, and planted faults that fail their numbers."""

import pytest
import torch

from benchmark.lib import flops_fpn as FL
from benchmark.lib import harness as H
from benchmark.lib import weights_fpn as W
from benchmark.reference import mask_rcnn_fpn as R
from benchmark.tests import small

SPEC = H.load_json(H.ROOT, "BENCHMARK.json")
CELL = "mask_rcnn_r101_fpn.detect_b1"
SEED = 2**31 + 77
METRICS = {"fpn_ms.fpn", "proposals_span_ms.fpn", "roi_align_roofline.fpn",
           "mask_head_ms.fpn", "mask_dets.fpn", "mfu.fpn", "device_idle.fpn"}
INEXACT = {"nms_gap", "score_err", "box_err_px", "mask_err"}


def _failed(out):
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


def test_cell_names_what_exists():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[CELL]["config"] == "mask_rcnn_r101_fpn_coco"
    assert cells[CELL]["chips"] == 1
    e2e = {m["name"]: m.get("workloads") for m in SPEC["end_to_end"]}
    assert CELL in e2e["latency_p50_ms"] and CELL in e2e["latency_p95_ms"]
    _, work, cfg, traffic, e2e, per_layer, _ = H.load_cell(CELL)
    assert set(per_layer) == METRICS
    assert set(e2e) == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    assert work["driver"] == "detect_2d_fpn" and traffic["batch"] == 1
    assert set(work["limits"]) == INEXACT | {
        "nms_overlap", "missing_rois", "level_mismatch", "dets_mismatch"}
    assert cfg["reduced"] == [] and cfg["stages"] == [3, 4, 23, 3]
    assert (cfg["image_hw"], cfg["fpn_dim"], cfg["box_pooled"],
            cfg["mask_pooled"], cfg["fc_dim"]) == ([800, 1088], 256, 7, 14,
                                                   1024)
    assert traffic["bucket_hw"] == cfg["image_hw"]


def test_flops_by_hand():
    """At 800x1088: the trunk with res5 262.57 GFLOP, the pyramid 98.60,
    the RPN 86.05, the box head 28.6 MFLOP a roi and the mask head 1.06
    GFLOP a detection, 2 x H x W x Cin x Cout x k^2 a conv."""
    cfg = H.load_cell(CELL)[2]

    def conv(h, w, cin, cout, k=1):
        return 2 * h * w * cin * cout * k * k

    def block(h, w, cin, m, cout, proj):
        return (conv(h, w, cin, m) + conv(h, w, m, m, 3) + conv(h, w, m, cout)
                + (conv(h, w, cin, cout) if proj else 0))

    res5 = block(25, 34, 1024, 512, 2048, True) + 2 * block(
        25, 34, 2048, 512, 2048, False)
    levels = [(200, 272), (100, 136), (50, 68), (25, 34), (13, 17)]
    assert FL.level_shapes(cfg["image_hw"]) == levels
    from benchmark.lib.flops_r101 import trunk_flops
    assert FL.backbone_flops(cfg) == trunk_flops(cfg)[0] + res5
    fpn = sum(conv(h, w, c, 256) + conv(h, w, 256, 256, 3)
              for (h, w), c in zip(levels, (256, 512, 1024, 2048)))
    rpn = sum(conv(h, w, 256, 256, 3) + conv(h, w, 256, 3)
              + conv(h, w, 256, 12) for h, w in levels)
    box = 2 * (12544 * 1024 + 1024 * 1024 + 1024 * 81 + 1024 * 320)
    mask = 4 * conv(14, 14, 256, 256, 3) + conv(28, 28, 256, 256) + conv(
        28, 28, 256, 80)
    assert (FL.fpn_flops(cfg), FL.rpn_flops(cfg)) == (fpn, rpn)
    assert (FL.box_head_flops_per_roi(cfg), FL.mask_flops_per_det(cfg)) == (
        box, mask)
    assert FL.image_flops(cfg, 50) == (FL.backbone_flops(cfg) + fpn + rpn
                                       + 1000 * box + 50 * mask)
    assert 262.5e9 < FL.backbone_flops(cfg) < 262.6e9
    assert 581e9 < FL.image_flops(cfg, 100) < 582e9


def test_roi_align_bytes_count_cells_once():
    """Two equal rois of 16x16 px on P2 (a 4x4-cell box shifted by -0.5,
    its samples on rows and columns 0-4 of a 10x10 map) and one wholly off
    the map: 25 cells read once, 3 pooled 7x7x8 maps written, the rois and
    levels of 3 slots."""
    boxes = torch.tensor([[0.0, 0.0, 16.0, 16.0], [0.0, 0.0, 16.0, 16.0],
                          [-100.0, -100.0, -60.0, -60.0]])
    levels = torch.tensor([2, 2, 2])
    got = FL.roi_align_bytes(boxes, levels, [(10, 10)] * 4, 8, 7, 2, 3)
    assert got == (25 + 3 * 49) * 8 * 2 + 3 * 24


def test_reference_copy_is_torch_reference():
    """The benchmark's frozen copy computes torch_reference's network bit
    for bit on the weight maker's weights (its widths, a 64x96 image):
    trunk, pyramid, RPN, anchors, RoIAlign, box head, mask head."""
    from torch_reference import mask_rcnn_r101_fpn as tref
    cfg = H.load_cell(CELL)[2]
    raw = W.make(cfg, 5, "cpu")
    gen = torch.Generator().manual_seed(6)
    image = torch.randn(64, 96, 3, generator=gen) * 60
    boxes = torch.tensor([[3.0, 4.0, 40.0, 50.0], [-10.0, 5.0, 95.0, 63.0],
                          [20.5, 10.25, 21.0, 12.0]])
    with torch.no_grad():
        maps = R.fpn(raw, R.trunk(raw, image))
        want = tref.fpn(raw, tref.trunk(raw, image))
        for a, b in zip(maps, want):
            assert torch.equal(a, b)
        for a, b in zip(R.rpn(raw, maps[1]), tref.rpn(raw, maps[1])):
            assert torch.equal(a, b)
        for lv, (h, w) in zip(R.LEVELS, [(16, 24), (8, 12), (4, 6), (2, 3),
                                         (1, 2)]):
            assert torch.equal(R.anchors(h, w, lv), tref.anchors(h, w, lv))
        for p in (7, 14):
            assert torch.equal(R.roi_align(maps[:4], boxes, p),
                               tref.roi_align(maps[:4], boxes, p))
        pooled = R.roi_align(maps[:4], boxes, 7)
        for a, b in zip(R.box_head(raw, pooled), tref.box_head(raw, pooled)):
            assert torch.equal(a, b)
        pooled = R.roi_align(maps[:4], boxes, 14)
        assert torch.equal(R.mask_logits(raw, pooled),
                           tref.mask_logits(raw, pooled))


def _run(post_nms=None):
    files = small.cell_files(CELL)
    if post_nms:
        files[2]["test"]["post_nms_top_n"] = post_nms
    return H.run_cell(CELL, SEED, 0.2, False, device="cpu", cell_files=files)


def test_sound_run_passes():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"]["level_mismatch"]["value"] == 0


def test_control_fails():
    """The control (the reference in float8 in the program's place) fails
    an inexact number at small shapes."""
    from benchmark.drivers import detect_2d_fpn
    _, work, cfg, traffic, *_ = small.cell_files(CELL)
    drv = detect_2d_fpn.Driver(cfg, traffic, SEED, "cpu")
    drv.release()
    got = drv.judge(control=True)
    assert {k for k in INEXACT if got[k] > work["limits"][k]}, got


def _fault(monkeypatch, fault):
    from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
    from mv3d_tf_tpu_torch.models import fpn
    from mv3d_tf_tpu_torch.ops import roi_align as RA
    if fault == "no_shift":
        real = RA.roi_align

        def roi_align(maps, rois, pooled, k_min=2):
            # each roi moved by half a cell of its level: the -0.5 undone
            k = RA.assign_levels(rois[:, 1:5], k_min, k_min + len(maps) - 1)
            half = (0.5 * 2.0 ** k.float())[:, None]
            return real(maps, torch.cat([rois[:, :1], rois[:, 1:] + half],
                                        1), pooled, k_min)
        monkeypatch.setattr(RA, "roi_align", roi_align)
    elif fault == "next_level":
        real = RA.assign_levels

        def assign_levels(boxes, k_min, k_max):
            k = real(boxes, k_min, k_max).clone()
            k[0] = k[0] + 1 if k[0] < k_max else k[0] - 1
            return k
        monkeypatch.setattr(RA, "assign_levels", assign_levels)
    elif fault == "mask_channel":
        real = fpn.mask_probs

        def mask_probs(params, pooled, classes, dtype=None):
            return real(params, pooled, (classes % 80) + 1, dtype)
        monkeypatch.setattr(fpn, "mask_probs", mask_probs)
    else:
        real = F2.proposal_layer_fpn

        def proposal_layer_fpn(logits, deltas, anchors, counts, *a, **kw):
            logits, counts = logits.clone(), counts.clone()
            logits[-1], counts[-1] = float("-inf"), 0
            return real(logits, deltas, anchors, counts, *a, **kw)
        monkeypatch.setattr(F2, "proposal_layer_fpn", proposal_layer_fpn)


@pytest.mark.parametrize("fault,number", [
    ("no_shift", INEXACT - {"nms_gap"}), ("next_level", {"level_mismatch"}),
    ("mask_channel", {"mask_err"}), ("drop_p6", {"missing_rois"})])
def test_faults(monkeypatch, fault, number):
    """RoIAlign without the -0.5 shift, a roi pooled from the next level,
    the mask channel of class c in place of c - 1, and P6 dropped from the
    proposals: each fails its number. At the small image P6's boxes are the
    whole image and score below the best 20, so that fault runs with room
    for every proposal the levels' NMS keeps (1000 slots)."""
    _fault(monkeypatch, fault)
    out = _run(1000 if fault == "drop_p6" else None)
    assert not out["correct"] and _failed(out) & number, out["checks"]
