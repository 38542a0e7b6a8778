"""The port's Faster R-CNN ResNet-101 C4 (models/resnet.py through
faster_rcnn_2d.build_im_detect_2d) against the plain float32 reference
torch_reference/faster_rcnn_r101_c4.py on the CPU, on seeded random
weights whose frozen BN statistics are random too, so that the fold is no
identity: the fold, one bottleneck of each kind, the trunk and res5 at full
widths on a small image, the whole im_detect at a small bucket and budget,
the network spec, and test_net_2d through the spec.

Tolerances: the port folds each BN into its conv, the reference applies it
after a bias-free conv, so the two round each layer differently in float32
(about 1e-7 relative a layer); over the 101 layers and the residual sums
that reaches some 1e-5 relative. The keep set, an integer selection, is
equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch import faster_rcnn_2d as F2  # noqa: E402
from mv3d_tf_tpu_torch.models import resnet  # noqa: E402
from mv3d_tf_tpu_torch.models.factory import get_network  # noqa: E402
from torch_reference import faster_rcnn_r101_c4 as ref  # noqa: E402

SEED = 20261018
HW = (64, 96)                # a 4x6 grid at stride 16


@pytest.fixture(scope="module")
def raw():
    gen = torch.Generator().manual_seed(SEED)
    return resnet.init_raw_r101_c4(gen, device="cpu")


@pytest.fixture(scope="module")
def params(raw):
    return resnet.params_from_raw(raw)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _image(seed, hw=HW):
    """A mean-subtracted 8-bit-like image (H, W, 3) float32."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.uniform(0, 255, (*hw, 3)) - 115.0)
                            .astype(np.float32))


def test_fold_is_conv_then_frozen_bn(raw):
    """A folded conv equals the conv and its frozen BN, within float32
    rounding, on a conv whose BN is far from an identity."""
    d = raw["res3_0_conv2"]
    s = d["gamma"] / torch.sqrt(d["var"] + resnet.BN_EPS)
    assert (s - 1).abs().max() > 0.15 and d["mean"].abs().max() > 0.1
    x = torch.randn(2, 128, 9, 11, generator=torch.Generator().manual_seed(1))
    w, b = resnet.fold_frozen_bn(d["weight"], d["gamma"], d["beta"],
                                 d["mean"], d["var"])
    got = torch.nn.functional.conv2d(x, w, b, padding=1)
    assert _rel(got, ref.conv_bn(x, d, relu=False)) < 1e-5


@pytest.mark.parametrize("block,stride", [("res4_5_", 1), ("res3_0_", 2)],
                         ids=["identity", "projection"])
def test_bottleneck(raw, params, block, stride):
    """One bottleneck of each kind: the identity shortcut (res4's sixth)
    and the strided projection (res3's first), against the reference's
    unfolded block."""
    cin = 1024 if block.startswith("res4") else 256
    x = torch.relu(torch.randn(1, 8, 12, cin,
                               generator=torch.Generator().manual_seed(2)))
    got = resnet.bottleneck(params, x, block, stride)
    want = ref.bottleneck(raw, x.permute(0, 3, 1, 2), block, stride)
    assert got.shape == want.permute(0, 2, 3, 1).shape
    assert _rel(got, want.permute(0, 2, 3, 1)) < 1e-5


def test_trunk_and_res5_full_width(raw, params):
    """The shared trunk on a 64x96 image to res4 (4x6x1024), and res5 with
    its mean on 8 pooled RoI maps (14x14x1024)."""
    image = _image(3)
    got = resnet.trunk_apply_r101(params, image[None])
    want = ref.trunk(raw, image).permute(0, 2, 3, 1)
    assert got.shape == (1, 4, 6, 1024)
    assert _rel(got, want) < 2e-5
    gen = torch.Generator().manual_seed(4)
    pooled = torch.relu(torch.randn(8, 14, 14, 1024, generator=gen))
    got5 = resnet.res5_head(params, pooled)
    assert got5.shape == (8, 2048)
    assert _rel(got5, ref.res5(raw, pooled)) < 2e-5


def test_init_keeps_each_stage_at_scale(params):
    """The init's rule: every stage's output RMS within 4x of its input's,
    from the stem through res5."""
    x = resnet.stem(params, _image(5, (128, 192))[None])
    for spec in resnet.STAGES + (resnet.RES5,):
        y = resnet.stage(params, x, spec)
        ratio = float(y.pow(2).mean().sqrt() / x.pow(2).mean().sqrt())
        assert 0.25 < ratio < 4.0, (spec[0], ratio)
        x = y


def test_im_detect_matches_reference(raw, params):
    """The whole detector at a 96x160 bucket, pre-/post-NMS 120/16: the
    keep set equal, rois within 1e-2 px, 1e-4 of the image's width (a
    delta's float32 rounding times anchors of up to 512 px), the class
    boxes within 3e-2 px (the rois' error through a second decode), and
    scores within 1e-5."""
    image = _image(6, (96, 160))
    info = np.array([90.0, 150.0, 1.0], np.float32)
    spec = get_network("Res101C4_test")
    got = F2.build_im_detect_2d(6, 10, pre_nms_top_n=120, post_nms_top_n=16,
                                spec=spec)(params, image, info)
    want = ref.im_detect(raw, image, torch.from_numpy(info), pre_nms=120,
                         post_nms=16)
    n = len(want["rois"])
    assert n >= 8 and int(got["valid"].sum()) == n
    assert bool(got["valid"][:n].all())
    assert float((got["rois"][:n, 1:] - want["rois"]).abs().max()) < 1e-2
    assert got["scores"].shape == (16, 81) and got["boxes"].shape == (16, 324)
    assert float((got["scores"][:n] - want["scores"]).abs().max()) < 1e-5
    assert float((got["boxes"][:n] - want["boxes"]).abs().max()) < 3e-2
    assert float(got["scores"][n:].abs().sum()) == 0.0


def test_network_spec():
    """Res101C4_test is a 2D network: the ResNet-101 C4 trunk and head,
    stride 16, anchor scales 2-32, a 14x14 pool, 81 classes, COCO's
    800x1344 bucket; it has no train network, and VGGnet's spec carries
    the VGG16 path's own functions and sizes."""
    spec = get_network("Res101C4_test")
    assert (spec.is_2d, spec.mode) == (True, "test")
    assert (spec.trunk_apply, spec.head, spec.init_params) == (
        resnet.trunk_apply_r101, resnet.detect_head,
        resnet.init_params_r101_c4)
    assert (spec.feat_stride, spec.pooled, spec.n_classes,
            spec.bucket_hw) == (16, 14, 81, (800, 1344))
    assert tuple(spec.anchor_scales) == (2, 4, 8, 16, 32)
    from mv3d_tf_tpu_torch.models import vggnet
    vgg = get_network("VGGnet_test")
    assert (vgg.trunk_apply, vgg.head, vgg.init_params) == (
        vggnet.trunk_apply_2d, vggnet.detect_head_2d, vggnet.init_params_2d)
    assert (tuple(vgg.anchor_scales), vgg.pooled, vgg.n_classes,
            vgg.bucket_hw) == ((8, 16, 32), 7, 21, (608, 1024))
    with pytest.raises(KeyError, match="test network only"):
        get_network("Res101C4_train")


def test_trunk_graphs_on_the_cpu_are_the_trunk(params):
    """ResNet-101 C4's spec runs its trunk as CUDA graphs on the card
    (resnet.TrunkGraphs, one instance a detector), which on the CPU run
    trunk_apply_r101 itself; VGGnet's spec has none."""
    spec = get_network("Res101C4_test")
    assert spec.trunk_graphs is resnet.TrunkGraphs
    assert get_network("VGGnet_test").trunk_graphs is None
    x = _image(5)[None]
    assert torch.equal(spec.trunk_graphs()(params, x),
                       resnet.trunk_apply_r101(params, x))


def test_vgg_spec_is_the_default_path(monkeypatch):
    """build_im_detect_2d with VGGnet's spec and with none make the same
    calls: the same outputs bit for bit on a small VGG16."""
    from mv3d_tf_tpu_torch.models import vggnet
    gen = torch.Generator().manual_seed(3)
    params = vggnet.init_params_2d(gen, fc_dim=32, device="cpu")
    with torch.no_grad():
        for m in params.values():
            m.weight.mul_(30.0)
    image, info = _image(7), np.array([64.0, 96.0, 1.0], np.float32)
    kw = dict(pre_nms_top_n=40, post_nms_top_n=8)
    a = F2.build_im_detect_2d(4, 6, **kw)(params, image, info)
    b = F2.build_im_detect_2d(4, 6, spec=get_network("VGGnet_test"),
                              **kw)(params, image, info)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_test_net_2d_runs_the_spec(params, tmp_path, monkeypatch):
    """solver.test_net_2d over a synthetic VOC test split with the spec:
    detections for every image and class (81 classes' heads cut to VOC's
    21), the pickle written."""
    from mv3d_tf_tpu_torch import solver
    from mv3d_tf_tpu_torch.config import cfg
    from mv3d_tf_tpu_torch.data import synthetic
    from mv3d_tf_tpu_torch.data.kitti import get_imdb
    monkeypatch.setattr(cfg, "ROOT_DIR", str(tmp_path))
    monkeypatch.setattr(cfg, "DATA_DIR", str(tmp_path / "data"))
    for key, v in (("SCALES", (64,)), ("MAX_SIZE", 96),
                   ("RPN_PRE_NMS_TOP_N", 40), ("RPN_POST_NMS_TOP_N", 4)):
        monkeypatch.setattr(cfg.TEST, key, v)
    devkit = synthetic.generate_voc(str(tmp_path / "VOCdevkit"),
                                    num_images=2, seed=1)
    imdb = get_imdb("voc_2007_test", devkit_path=devkit)
    gen = torch.Generator().manual_seed(SEED)
    voc = resnet.init_params_r101_c4(gen, n_classes=21, device="cpu")
    aps = solver.test_net_2d(voc, imdb, bucket_hw=(64, 96), thresh=0.0,
                             log=lambda s: None,
                             spec=get_network("Res101C4_test"))
    assert len(aps) == 20
    assert (tmp_path / "output").exists()


def test_test_net_cli_runs_res101(tmp_path, monkeypatch):
    """tools/test_net --network Res101C4_test --bucket on the CPU over a
    synthetic VOC split: the port's own init, the detections pickle and
    the 20 VOC APs."""
    from mv3d_tf_tpu_torch.config import cfg
    from mv3d_tf_tpu_torch.data import synthetic
    from mv3d_tf_tpu_torch.tools import test_net
    for sect, key in (("TEST", "SCALES"), ("TEST", "MAX_SIZE"),
                      ("TEST", "RPN_PRE_NMS_TOP_N"),
                      ("TEST", "RPN_POST_NMS_TOP_N"), (None, "ROOT_DIR"),
                      (None, "DATA_DIR")):
        d = cfg if sect is None else cfg[sect]
        monkeypatch.setattr(d, key, d[key])     # restored after the test
    devkit = synthetic.generate_voc(str(tmp_path / "VOCdevkit"),
                                    num_images=2, seed=2)
    aps = test_net.main([
        "--network", "Res101C4_test", "--imdb", "voc_2007_test",
        "--devkit_path", devkit, "--device", "cpu", "--dtype", "float32",
        "--bucket", "64", "96", "--set", "TEST.SCALES", "[64]",
        "TEST.MAX_SIZE", "96", "TEST.RPN_PRE_NMS_TOP_N", "40",
        "TEST.RPN_POST_NMS_TOP_N", "4", "ROOT_DIR", str(tmp_path),
        "DATA_DIR", str(tmp_path / "data")])
    assert len(aps) == 20
    assert list(tmp_path.glob("output/**/detections.pkl"))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs are captured only there")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_card_trunk_graphs_are_the_eager_trunk(params, cuda, dtype):
    """On the card resnet.TrunkGraphs gives trunk_apply_r101's map bit for
    bit: on two inputs in turn (the second a replay), after a weight is
    written in place (the replay reads it), and for another parameter set
    (captured anew)."""
    import copy
    p = copy.deepcopy(params).to(cuda)
    graphs = resnet.TrunkGraphs()

    def same(q, x):
        got = graphs(q, x, dtype).clone()
        want = resnet.trunk_apply_r101(q, x, dtype)
        torch.cuda.synchronize()
        assert torch.equal(got, want)

    x1, x2 = (_image(s, (96, 128))[None].to(cuda) for s in (1, 2))
    same(p, x1)
    same(p, x2)
    p["res4_5_conv2"].weight.mul_(1.5)
    same(p, x1)
    q = copy.deepcopy(p)
    q["conv1"].weight.mul_(0.5)
    same(q, x2)
    same(p, x2)
