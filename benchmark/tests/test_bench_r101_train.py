"""The cells faster_rcnn_r101.detect_b1 and mv3d.train_b1: their files name
what exists, the ResNet-101 C4 FLOP counter against sums written out by
hand, the benchmark's copy of the reference against torch_reference/, and
planted faults that the judgements fail, at small shapes on the CPU."""

import copy

import pytest
import torch

from benchmark.lib import flops_r101 as FL
from benchmark.lib import harness as H
from benchmark.lib import weights_r101 as W
from benchmark.reference import resnet_c4
from benchmark.tests import small

SPEC = H.load_json(H.ROOT, "BENCHMARK.json")
R101, TRAIN = "faster_rcnn_r101.detect_b1", "mv3d.train_b1"
SEED = 2**31 + 77


def _failed(out):
    return {k for k, c in out["checks"].items() if c["value"] > c["limit"]}


def train_files():
    """mv3d.train_b1's files at small shapes: a 64x64 raster, a 64x128
    image, fc 64, pre-/post-NMS 200/20, a pool of 2 frames of 20,000
    points."""
    cell, work, cfg, traffic, e2e, per_layer, units = H.load_cell(TRAIN)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update({"bev_hw": [64, 64], "image_hw": [64, 128], "fc_dim": 64})
    cfg["train"].update({"pre_nms_top_n": 200, "post_nms_top_n": 20})
    traffic.update({"pool": 2, "points": 20000, "car_range_m": [3.0, 6.0]})
    return cell, work, cfg, traffic, e2e, per_layer, units


def test_new_cells_name_what_exists():
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert cells[R101]["config"] == "faster_rcnn_r101_c4_coco"
    assert cells[TRAIN]["config"] == "mv3d_kitti_vgg16"
    assert cells[R101]["chips"] == cells[TRAIN]["chips"] == 1
    e2e = {m["name"]: m.get("workloads") for m in SPEC["end_to_end"]}
    assert R101 in e2e["latency_p50_ms"] and R101 in e2e["latency_p95_ms"]
    assert TRAIN in e2e["frames_per_s"]
    for cell, metrics in ((R101, {"res5_head_ms.r101", "res5_head_mfu.r101",
                                  "roi_pool_roofline.r101",
                                  "res4_span_ms.r101", "res4_launches.r101",
                                  "mfu.r101", "device_idle.r101",
                                  "proposals_span_ms.2d",
                                  "proposals_launches.2d",
                                  "idle_in_proposals.2d", "nms_rounds.2d"}),
                          (TRAIN, {"mfu.train", "device_idle.train"})):
        _, work, cfg, traffic, _, per_layer, _ = H.load_cell(cell)
        assert set(per_layer) == metrics
        assert H.driver_class(work["driver"]).ITEMS_METRIC
        assert traffic["batch"] == 1
    cfg = H.load_cell(R101)[2]
    assert cfg["reduced"] == [] and cfg["stages"] == [3, 4, 23, 3]
    assert (cfg["image_hw"], cfg["pooled"], cfg["num_anchors"]) == (
        [800, 1088], 14, 15)


def test_r101_flops_by_hand():
    """res5 a RoI is 1.464 GFLOP and the trunk 237 GFLOP at 800x1088:
    2 x H x W x Cin x Cout x k^2 a conv, written out stage by stage."""
    cfg = H.load_cell(R101)[2]

    def conv(h, w, cin, cout, k=1):
        return 2 * h * w * cin * cout * k * k

    def block(h, w, cin, m, cout, proj):
        return (conv(h, w, cin, m) + conv(h, w, m, m, 3) + conv(h, w, m, cout)
                + (conv(h, w, cin, cout) if proj else 0))

    # res5 on a 14x14x1024 map: the strided first block at 7x7, two more
    res5 = block(7, 7, 1024, 512, 2048, True) + 2 * block(7, 7, 2048, 512,
                                                          2048, False)
    assert res5 == FL.res5_flops_per_roi(cfg) == 1464336384
    # the 7x7/2 stem to 400x544, the pool to 200x272, res2 there, res3 at
    # 100x136, res4 at 50x68
    trunk = (conv(400, 544, 3, 64, 7)
             + block(200, 272, 64, 64, 256, True)
             + 2 * block(200, 272, 256, 64, 256, False)
             + block(100, 136, 256, 128, 512, True)
             + 3 * block(100, 136, 512, 128, 512, False)
             + block(50, 68, 512, 256, 1024, True)
             + 22 * block(50, 68, 1024, 256, 1024, False))
    assert (trunk, (50, 68)) == FL.trunk_flops(cfg)
    assert 236.5e9 < trunk < 237.5e9
    rpn = conv(50, 68, 1024, 1024, 3) + conv(50, 68, 1024, 30) + conv(
        50, 68, 1024, 60)
    heads = 1000 * 2 * 2048 * 81 * 5
    assert FL.image_flops(cfg) == trunk + rpn + 1000 * res5 + heads


def test_roi_pool_bytes_count_cells_once():
    """Two rois over the same 2x2 cells of a 4x4x8 bf16 map at stride 1:
    the 4 cells read once, 2 x 14 x 14 x 8 values written, 10 rois
    floats."""
    rois = torch.tensor([[0, 0, 0, 1, 1], [0, 0, 0, 1, 1]],
                        dtype=torch.float32)
    assert FL.roi_pool_bytes(rois, (4, 4, 8), 14, 1.0, 2) == (
        4 * 8 * 2 + 2 * 196 * 8 * 2 + 10 * 4)


def test_reference_copy_is_torch_reference():
    """The benchmark's frozen copy computes torch_reference's network bit
    for bit on the weight maker's weights (its widths, a 64x96 image)."""
    from torch_reference import faster_rcnn_r101_c4 as tref
    cfg = H.load_cell(R101)[2]
    raw = W.make(cfg, 5, "cpu")
    gen = torch.Generator().manual_seed(6)
    image = torch.randn(64, 96, 3, generator=gen) * 60
    pooled = torch.relu(torch.randn(3, 14, 14, 1024, generator=gen))
    with torch.no_grad():
        feat = resnet_c4.trunk(raw, image)
        assert torch.equal(feat, tref.trunk(raw, image))
        for a, b in zip(resnet_c4.rpn(raw, feat), tref.rpn(raw, feat)):
            assert torch.equal(a, b)
        assert torch.equal(resnet_c4.res5(raw, pooled),
                           tref.res5(raw, pooled))


def _r101():
    return H.run_cell(R101, SEED, 0.2, False, device="cpu",
                      cell_files=small.cell_files(R101))


def test_r101_sound_run_passes():
    out = _r101()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["dropped_residual", "unfolded_bn"])
def test_r101_faults(monkeypatch, fault):
    """A residual add dropped in res4's eighth block, or one BN left out of
    its conv (the projection of res4's first block: its weight taken raw,
    its bias 0): the scores or boxes fail."""
    from mv3d_tf_tpu_torch.models import resnet
    if fault == "dropped_residual":
        from mv3d_tf_tpu_torch.models import vgg
        real = resnet.bottleneck

        def bottleneck(params, x, name, stride, dtype=None):
            if name != "res4_7_":
                return real(params, x, name, stride, dtype)

            def c(suffix, y, s=1, relu=True):
                return resnet.conv(y, *vgg.layer(params, name + suffix),
                                   stride=s, relu=relu, dtype=dtype)
            return torch.relu(c("conv3", c("conv2", c("conv1", x, stride)),
                                relu=False))
        monkeypatch.setattr(resnet, "bottleneck", bottleneck)
    else:
        real = resnet.params_from_raw

        def params_from_raw(raw):
            raw = dict(raw)
            d = raw["res4_0_shortcut"]
            raw["res4_0_shortcut"] = {"weight": d["weight"],
                                   "bias": torch.zeros_like(d["beta"])}
            return real(raw)
        monkeypatch.setattr(resnet, "params_from_raw", params_from_raw)
    out = _r101()
    assert not out["correct"]
    assert _failed(out) & {"score_err", "box_err_px"}, out["checks"]


def _train(monkeypatch=None, scale=None):
    from benchmark.drivers import train_b1
    if scale is not None:
        real = train_b1.Driver.params

        def params(self):
            p = real(self)
            p[scale].weight.register_hook(lambda g: g * 1.1)
            return p
        monkeypatch.setattr(train_b1.Driver, "params", params)
    return H.run_cell(TRAIN, SEED, 0.2, False, device="cpu",
                      cell_files=train_files())


def test_train_sound_run_passes():
    out = _train()
    assert out["correct"], out["checks"]
    assert out["checks"]["anchor_mismatch"]["value"] == 0


def test_train_gradient_scaled_fails(monkeypatch):
    """One layer's weight gradient (the RPN conv's) scaled by 1.1 in the
    program: its length along the reference's is 10% off."""
    out = _train(monkeypatch, "rpn_conv__3x3")
    assert not out["correct"] and "grad_scale_err" in _failed(out)


def _drop_top(out):
    """The proposals without their top-scoring box: every slot moved up
    by one, the last left empty."""
    d = out["valid"].dim() - 1
    n = out["valid"].shape[d]
    return {k: torch.cat([v.narrow(d, 1, n - 1),
                          torch.zeros_like(v.narrow(d, 0, 1))], d)
            if torch.is_tensor(v) and v.dim() > d and v.shape[d] == n else v
            for k, v in out.items()}


def _half(out):
    """The proposals with the second half of their slots left empty."""
    n = out["valid"].shape[-1]
    keep = torch.arange(n, device=out["valid"].device) < n // 2
    return dict(out, valid=out["valid"] & keep)


@pytest.mark.parametrize("fault", ["proposals_drop_top", "proposals_half",
                                   "adam_beta1"])
def test_train_faults(monkeypatch, fault):
    """Planted faults in the program's step fail the train judge: a
    proposal layer that drops its top-scoring box (its last slot is left
    empty while the dropped box stays free) or returns too few
    (missing_rois), and Adam with beta1 0.8 in place of 0.9, which the
    first step from zero moments cannot show and the second does
    (adam_err)."""
    from mv3d_tf_tpu_torch import train
    if fault == "adam_beta1":
        real = train.build_train_step

        def build_train_step(**kw):
            step, _ = real(**kw)
            return step, lambda p: torch.optim.Adam(
                p.parameters(), lr=kw["lr"], betas=(0.8, 0.999), eps=1e-8)
        monkeypatch.setattr(train, "build_train_step", build_train_step)
        want = {"adam_err"}
    else:
        real = train.proposal_layer_3d
        edit = _drop_top if fault == "proposals_drop_top" else _half
        monkeypatch.setattr(train, "proposal_layer_3d",
                            lambda *a, **kw: edit(dict(real(*a, **kw))))
        want = {"missing_rois"}
    out = _train()
    assert not out["correct"] and want <= _failed(out), out["checks"]
