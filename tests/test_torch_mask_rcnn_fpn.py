"""The port's Mask R-CNN ResNet-101-FPN (models/fpn.py through
faster_rcnn_2d.build_im_detect_2d, the class step and build_im_mask_2d;
ops/roi_align.py) against the plain float32 reference
torch_reference/mask_rcnn_r101_fpn.py on the CPU, on seeded random
weights at the published widths and a small image: the pyramid, the
per-level proposals and their five-frame NMS, the level rule at its edges,
RoIAlign, the box head and decode, the class step, the masks, the network
spec and test_net_2d through it.

Tolerances: the port folds each BN into its conv and the reference applies
it after a bias-free conv (about 1e-7 relative a layer, some 2e-5 over the
trunk); integer selections (keep sets, levels) are equal."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch import faster_rcnn_2d as F2  # noqa: E402
from mv3d_tf_tpu_torch import solver  # noqa: E402
from mv3d_tf_tpu_torch.models import fpn, resnet  # noqa: E402
from mv3d_tf_tpu_torch.models.factory import get_network  # noqa: E402
from mv3d_tf_tpu_torch.ops import roi_align as RA  # noqa: E402
from torch_reference import mask_rcnn_r101_fpn as ref  # noqa: E402

SEED = 20261019
HW = (128, 192)                  # P2 32x48 ... P6 2x3
INFO = np.array([120.0, 180.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def raw():
    return fpn.init_raw_mask_rcnn_fpn(torch.Generator().manual_seed(SEED),
                                      device="cpu")


@pytest.fixture(scope="module")
def params(raw):
    return fpn.params_from_raw(raw)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _image(seed, hw=HW):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.uniform(0, 255, (*hw, 3)) - 115.0)
                            .astype(np.float32))


@pytest.fixture(scope="module")
def run(raw, params):
    """One image through the port (float32) and the reference: the port's
    outputs and pyramid, the reference's pyramid and proposals."""
    image = _image(1)
    detect = F2.build_im_detect_2d(0, 0, pre_nms_top_n=100,
                                   post_nms_top_n=60,
                                   spec=get_network("MaskRCNN_R101_FPN_test"))
    with torch.no_grad():
        out = detect(params, image, INFO)
        maps = ref.fpn(raw, ref.trunk(raw, image))
        rois, _, levels = ref.proposals(maps, raw, INFO, 100, 60)
    return {"out": out, "maps": list(detect.maps), "ref_maps": maps,
            "ref_rois": rois, "ref_levels": levels, "image": image}


def test_pyramid_levels(raw, params, run):
    """P2-P6 at strides 4-64 (P6 P5's every other cell), each within 2e-5
    of the reference's; the anchors' count is the RPN's."""
    image = run["image"]
    feats = fpn.trunk_apply(params, image[None])
    maps = fpn.neck(params, feats)
    shapes = fpn.level_shapes(HW)
    assert [tuple(m.shape[1:3]) for m in maps] == shapes == [
        (32, 48), (16, 24), (8, 12), (4, 6), (2, 3)]
    for got, want in zip(maps, run["ref_maps"]):
        assert _rel(got, want.permute(0, 2, 3, 1)) < 2e-5
    logits, deltas = fpn.rpn(params, maps)
    anchors, counts = F2._fpn_anchors(HW, torch.device("cpu"))
    assert anchors.shape == deltas.shape == (int(counts.sum()), 4)
    assert counts.tolist() == [h * w * 3 for h, w in shapes]
    assert torch.equal(anchors[:counts[0]], ref.anchors(32, 48, 2))
    assert bool(torch.isinf(logits[4, counts[4]:]).all())


def test_proposals_match_reference(run):
    """The detector's proposals: the reference's in its order, within 1e-2
    px (a delta's float32 rounding on anchors of up to 512 px), from the
    reference's levels."""
    out, rois = run["out"], run["ref_rois"]
    assert torch.equal(out["rpn_levels"][:len(rois)].long(),
                       run["ref_levels"].long())
    n = len(rois)
    assert n >= 10 and int(out["valid"].sum()) == n
    assert bool(out["valid"][:n].all())
    assert float((out["rois"][:n, 1:] - rois).abs().max()) < 1e-2
    assert float(out["rois"][n:].abs().sum()) == 0.0


def _per_level_greedy(logits, deltas, anchors, counts, info, k, post, th):
    """The five-frame NMS's promise written out: each level alone, top k,
    decode, clip, drop empties, the reference's greedy NMS; then the best
    ``post`` over the levels by a stable sort."""
    boxes_all, sc_all, lv_all, start = [], [], [], 0
    for lv, c in enumerate(counts.tolist()):
        lg = logits[lv, :c]
        order = torch.sort(lg, descending=True, stable=True)[1][:k]
        b = ref.c4.clip(ref.decode(anchors[start + order],
                                   deltas[start + order], (1.0,) * 4),
                        float(info[0]), float(info[1]))
        ok = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        b, sc = b[ok], lg[order][ok]
        keep = ref.greedy_nms(b, th, min(k, post))
        boxes_all.append(b[keep])
        sc_all.append(sc[keep])
        lv_all.append(torch.full((len(keep),), lv))
        start += c
    boxes, sc, lv = (torch.cat(x) for x in (boxes_all, sc_all, lv_all))
    order = torch.sort(sc, descending=True, stable=True)[1][:post]
    return boxes[order], sc[order], lv[order]


@pytest.mark.parametrize("k,post", [(40, 60), (25, 30)])
def test_five_frame_nms_is_per_level_greedy(k, post):
    """proposal_layer_fpn on crowded random anchors and deltas of five
    levels (the last shorter, padded with -inf): the rois and logits equal,
    bit for bit, each level's greedy NMS then the best ``post``."""
    gen = torch.Generator().manual_seed(k)
    counts = torch.tensor([120, 90, 60, 48, 30])
    n = int(counts.sum())
    xy = torch.rand(n, 2, generator=gen) * 150
    wh = 20 + torch.rand(n, 2, generator=gen) * 60
    anchors = torch.cat([xy, xy + wh], 1)
    deltas = torch.randn(n, 4, generator=gen) * 0.2
    logits = torch.full((5, 120), float("-inf"))
    for lv, c in enumerate(counts.tolist()):
        logits[lv, :c] = torch.randn(c, generator=gen)
    got, got_sc, valid, levels = F2.proposal_layer_fpn(
        logits, deltas, anchors, counts, INFO, k, post, 0.7)
    want, want_sc, want_lv = _per_level_greedy(logits, deltas, anchors,
                                               counts, INFO, k, post, 0.7)
    m = len(want)
    assert int(valid.sum()) == m and bool(valid[:m].all())
    assert torch.equal(got[:m, 1:], want) and torch.equal(got_sc[:m], want_sc)
    assert torch.equal(levels[:m].long(), want_lv)
    assert set(want_lv.tolist()) == {0, 1, 2, 3, 4}


def test_levels_at_the_edges():
    """Boxes of side 112, 224 and 448 open levels 3, 4 and 5, a hair less
    stays below; tiny boxes go to P2 and huge ones to P5, in the port's
    exact rule and the reference's log2."""
    sides = [8.0, 111.9, 112.0, 223.9, 224.0, 447.9, 448.0, 2000.0]
    boxes = torch.tensor([[10.0, 20.0, 10.0 + s, 20.0 + s] for s in sides])
    want = [2, 2, 3, 3, 4, 4, 5, 5]
    assert RA.assign_levels(boxes, 2, 5).tolist() == want
    assert ref.assign_levels(boxes).tolist() == want
    flat = torch.tensor([[0.0, 0.0, 224.0 * 4, 56.0]])   # area = 224^2
    assert RA.assign_levels(flat, 2, 5).tolist() == [4]


def _pyramid(gen, c, dtype=torch.float32):
    return [torch.randn(1, h, w, c, generator=gen).to(dtype)
            for h, w in ((32, 48), (16, 24), (8, 12), (4, 6))]


def _hard_rois(gen):
    """Rois off the map, across its edges, sub-pixel, and large enough
    for ceil sampling grids of 2-5 a bin, over all four levels."""
    rows = [[-50, -40, -10, -5], [-3, -2, 40, 30], [150, 100, 260, 190],
            [10.2, 10.7, 10.9, 11.1], [3.3, 4.1, 5.0, 6.2],
            [0, 0, 191, 127], [17.5, 9.25, 131.75, 100.5],
            [60, 30, 180, 125], [5, 5, 120, 70], [100, 20, 190, 126],
            [-60, -80, 240, 180], [-20, -40, 300, 220],
            [-200, -150, 420, 300], [-40, -30, 500, 400]]
    xy = torch.rand(22, 2, generator=gen) * 160
    wh = 2 + torch.rand(22, 2, generator=gen) * 170
    rows += torch.cat([xy, xy + wh], 1).tolist()
    return torch.cat([torch.zeros(len(rows), 1), torch.tensor(rows)], 1)


@pytest.mark.parametrize("pooled", [7, 14])
def test_roi_align_matches_reference(pooled):
    """ops/roi_align.roi_align against the reference's RoIAlign on rois off
    the map, sub-pixel and with ceil grids: float32 within 1e-6 of the
    maps' scale, the levels equal; bfloat16 maps give the float32 result
    of their values rounded once."""
    gen = torch.Generator().manual_seed(pooled)
    maps = _pyramid(gen, 8)
    rois = _hard_rois(gen)
    got, levels = RA.roi_align(maps, rois, pooled)
    want = ref.roi_align([m.permute(0, 3, 1, 2) for m in maps],
                         rois[:, 1:], pooled)
    assert got.shape == (len(rois), pooled, pooled, 8)
    assert float((got - want.permute(0, 2, 3, 1)).abs().max()) < 1e-6
    assert torch.equal(levels.long(), ref.assign_levels(rois[:, 1:]))
    assert set(levels.tolist()) == {2, 3, 4, 5}
    assert float(got[0].abs().max()) == 0.0          # wholly off the map
    bf = [m.to(torch.bfloat16) for m in maps]
    got_bf, _ = RA.roi_align(bf, rois, pooled)
    want_bf, _ = RA.roi_align([m.float() for m in bf], rois, pooled)
    assert got_bf.dtype == torch.bfloat16
    assert torch.equal(got_bf, want_bf.to(torch.bfloat16))


def test_box_head_and_decode(raw, params):
    """The box head on pooled maps (fc6's weight reordered to NHWC input
    once) and the class-specific decode with weights (10, 10, 5, 5): the
    reference's probabilities within 1e-5 and boxes within 1e-3 px."""
    gen = torch.Generator().manual_seed(5)
    pooled = torch.relu(torch.randn(12, 7, 7, 256, generator=gen))
    rois = _hard_rois(gen)[:12, 1:].clamp(0, 180)
    prob, deltas = fpn.box_head(params, pooled)
    want_p, want_d = ref.box_head(raw, pooled.permute(0, 3, 1, 2))
    assert prob.shape == (12, 81) and deltas.shape == (12, 320)
    assert float((prob - want_p).abs().max()) < 1e-5
    assert _rel(deltas, want_d) < 1e-5
    big = deltas * (30 / float(deltas.abs().max()))   # past the clamp
    assert float((big[:, 2::4] / 5).max()) > fpn.SCALE_CLAMP
    got = fpn.decode(rois, big, fpn.BOX_WEIGHTS)
    assert float((got - ref.decode(rois, big, ref.BOX_WEIGHTS)).abs().max()
                 ) < 1e-3
    assert bool(torch.isfinite(got).all())


def test_class_detections(run):
    """solver.class_detections_2d on the detector's output (background
    columns 0) keeps what the reference's class step keeps."""
    out = {k: v.numpy() for k, v in run["out"].items()}
    got = solver.class_detections_2d(out, INFO[2], 0.05, 0.5, 100)
    v = out["valid"]
    want = ref.class_detections(torch.from_numpy(out["scores"][v]),
                                torch.from_numpy(out["boxes"][v][:, 4:]),
                                float(INFO[2]))
    assert sum(len(d) for d in got) >= 5
    for a, b in zip(got, want):
        key = np.lexsort(a.T[::-1]) if len(a) else []
        keyb = np.lexsort(b.T[::-1]) if len(b) else []
        assert np.array_equal(a[key], b[keyb])


def test_mask_probabilities(raw, params, run):
    """The mask stage on the class step's detections against the
    pyramid im_detect left: each detection's 28x28 probabilities of its
    class within 1e-4 of the reference's, the levels the rule's; the
    neighbouring class's channel is another map."""
    out = {k: v.numpy() for k, v in run["out"].items()}
    dets = solver.class_detections_2d(out, INFO[2], 0.05, 0.5, 100)
    spec = get_network("MaskRCNN_R101_FPN_test")
    got = F2.build_im_mask_2d(spec)(params, run["maps"], dets, INFO[2])
    want = ref.masks(raw, run["ref_maps"], dets, float(INFO[2]))
    n = sum(len(d) for d in dets)
    assert len(got["masks"]) == 81 and len(got["levels"]) == n
    for a, b in zip(got["masks"], want):
        assert a.shape == b.shape and (len(a) == 0 or a.shape[1:] == (28, 28))
        if len(a):
            assert float(np.abs(a - b).max()) < 1e-4
    boxes = torch.from_numpy(np.concatenate([d[:, :4] for d in dets]))
    assert np.array_equal(got["levels"], ref.assign_levels(boxes).numpy())
    j = next(j for j in range(1, 81) if len(dets[j]))
    pooled, _ = RA.roi_align(run["maps"], torch.cat(
        [torch.zeros(1, 1), torch.from_numpy(dets[j][:1, :4])], 1), 14)
    other = fpn.mask_probs(params, pooled, torch.tensor([j % 80 + 1]))
    assert float(np.abs(other.numpy() - got["masks"][j][:1]).max()) > 1e-3


def test_network_spec():
    """MaskRCNN_R101_FPN_test is a 2D network with levels P2-P6, a box head
    and a mask head, 81 classes, a 7x7 and a 14x14 pooler, a budget of
    1000 a level and 1000 kept; it has no train network, and the other 2D
    specs have no levels."""
    spec = get_network("MaskRCNN_R101_FPN_test")
    assert (spec.is_2d, spec.levels, spec.n_classes) == (True,
                                                         (2, 3, 4, 5, 6), 81)
    assert (spec.head, spec.mask_head, spec.init_params) == (
        fpn.box_head, fpn.mask_probs, fpn.init_params_mask_rcnn_fpn)
    assert (spec.pooled, spec.mask_pooled, spec.test_budget,
            spec.bucket_hw) == (7, 14, (1000, 1000), (800, 1344))
    assert spec.trunk_stages is fpn.trunk_stages
    for name in ("Res101C4_test", "VGGnet_test"):
        assert get_network(name).levels is None
        assert get_network(name).mask_head is None
    with pytest.raises(KeyError, match="test network only"):
        get_network("MaskRCNN_R101_FPN_train")


def test_stage_graphs_on_the_cpu_are_eager(params):
    """resnet.StageGraphs runs its stages eagerly on the CPU: the trunk's
    five outputs are trunk_apply's, and the C4 trunk's graphs still give
    trunk_apply_r101's map."""
    x = _image(2, (64, 96))[None]
    outs = resnet.StageGraphs(fpn.trunk_stages)(params, x)
    assert len(outs) == 5
    for a, b in zip(outs[1:], fpn.trunk_apply(params, x)):
        assert torch.equal(a, b)
    assert torch.equal(resnet.TrunkGraphs()(params, x), outs[3])


def test_test_net_2d_runs_mask_rcnn(tmp_path, monkeypatch):
    """solver.test_net_2d with MaskRCNN_R101_FPN_test over a synthetic VOC
    split (heads cut to VOC's 21 classes): detections and masks for every
    image, both pickles written, the 20 APs."""
    import pickle

    from mv3d_tf_tpu_torch.config import cfg
    from mv3d_tf_tpu_torch.data import synthetic
    from mv3d_tf_tpu_torch.data.kitti import get_imdb
    monkeypatch.setattr(cfg, "ROOT_DIR", str(tmp_path))
    monkeypatch.setattr(cfg, "DATA_DIR", str(tmp_path / "data"))
    for key, v in (("SCALES", (64,)), ("MAX_SIZE", 96)):
        monkeypatch.setattr(cfg.TEST, key, v)
    spec = get_network("MaskRCNN_R101_FPN_test")
    monkeypatch.setattr(spec, "test_budget", (40, 20))
    devkit = synthetic.generate_voc(str(tmp_path / "VOCdevkit"),
                                    num_images=2, seed=1)
    imdb = get_imdb("voc_2007_test", devkit_path=devkit)
    voc = spec.init_params(torch.Generator().manual_seed(SEED), n_classes=21,
                           device="cpu")
    aps = solver.test_net_2d(voc, imdb, bucket_hw=(64, 96), thresh=0.0,
                             log=lambda s: None, spec=spec)
    assert len(aps) == 20
    path = next(tmp_path.glob("output/**/masks.pkl"))
    with open(path, "rb") as f:
        masks = pickle.load(f)
    with open(path.parent / "detections.pkl", "rb") as f:
        boxes = pickle.load(f)
    n = sum(len(boxes[j][i]) for j in range(1, 21) for i in range(2))
    assert n > 0 and n == sum(len(masks[j][i]) for j in range(1, 21)
                              for i in range(2))


def test_reference_stands_alone(raw):
    """The reference imports no JAX, nothing of mv3d_tf_tpu* and no kernel;
    its im_detect turns TF32 off."""
    code = ("import sys, torch_reference.mask_rcnn_r101_fpn; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'mv3d_tf_tpu', 'mv3d_tf_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
    torch.backends.cudnn.allow_tf32 = True
    try:
        ref.im_detect(raw, _image(3, (64, 96)),
                      torch.tensor([64.0, 96.0, 1.0]), pre_nms=20,
                      post_nms=10)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = True


# -- on the card -------------------------------------------------------------

@pytest.mark.card
def test_card_graphs_and_kernel_are_the_eager_path(params):
    """On the card the detector's graphs (trunk, pyramid, RPN) and the
    RoIAlign kernel give the eager path's outputs: the pyramid bit for
    bit, the pooled maps bit for bit against ops/roi_align.roi_align."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    import copy
    p = copy.deepcopy(params).cuda()
    x = _image(4, (96, 128))[None].cuda()
    trunk = resnet.StageGraphs(fpn.trunk_stages)
    head = resnet.StageGraphs(fpn.head_stages, copy_input=False)
    for dtype in (None, torch.bfloat16):
        feats = trunk(p, x, dtype)
        maps, _ = head(p, tuple(feats), dtype)
        want = fpn.neck(p, fpn.trunk_apply(p, x, dtype), dtype)
        for a, b in zip(maps, want):
            assert torch.equal(a, b)
        rois = _hard_rois(torch.Generator().manual_seed(1)).cuda()
        got, lv = RA.roi_align_fast(list(maps[:4]), rois, 7)
        plain, lv_plain = RA.roi_align(list(maps[:4]), rois, 7)
        assert torch.equal(got, plain) and torch.equal(lv, lv_plain)
