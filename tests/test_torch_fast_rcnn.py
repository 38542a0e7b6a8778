"""The port's Fast R-CNN training over precomputed proposals (the
cfg.TRAIN.HAS_RPN = False branch) against the JAX package's on CPU in
float32: one step of faster_rcnn_2d.build_fast_rcnn_train_step on 2 pyramid
levels of 64x96 with JAX's dropout masks rebuilt from its key, and the
training loop solver.train_net_fast_rcnn over a region-proposal roidb of a
synthetic VOC tree, its minibatches drawn from one np.random.RandomState
seed in both packages. fc6/fc7 are 64 wide (He weights from
utils.weights.he_normal_params_2d); the trunk is full width.

The port pools with roi_pool_train (the even split of dy among tied cells),
JAX with the XLA separable max under jax.grad; they differ only at ties,
which float32 maps from random weights do not have above 0 (and a tie at a
ReLU zero passes no gradient in either)."""

import copy
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mv3d_tf_tpu import faster_rcnn_2d as J2  # noqa: E402
from mv3d_tf_tpu import solver as JS  # noqa: E402
from mv3d_tf_tpu.config import cfg as jcfg  # noqa: E402
from mv3d_tf_tpu.data.pascal_voc import PascalVOC as JVOC  # noqa: E402
from mv3d_tf_tpu.models import vggnet as JV  # noqa: E402
from mv3d_tf_tpu_torch import faster_rcnn_2d as T2  # noqa: E402
from mv3d_tf_tpu_torch import solver as TS  # noqa: E402
from mv3d_tf_tpu_torch.config import cfg as tcfg  # noqa: E402
from mv3d_tf_tpu_torch.data import synthetic  # noqa: E402
from mv3d_tf_tpu_torch.data.pascal_voc import PascalVOC as TVOC  # noqa: E402
from mv3d_tf_tpu_torch.models import vggnet as TV  # noqa: E402
from mv3d_tf_tpu_torch.utils.weights import (he_normal_params_2d,  # noqa: E402
                                             params_from_jax, params_to_jax)

FC = 64
ROIS = 24


def _drop(key, n_rois, fc, keep_prob=0.5):
    """JAX's head splits the step key into the two dropout keys
    (vggnet.py:73-77); each gives a bernoulli keep mask of the fc output's
    shape (mv3d.py:87-92)."""
    return tuple(torch.tensor(np.asarray(jax.random.bernoulli(
        k, keep_prob, (n_rois, fc)))) for k in jax.random.split(key))


def _batch(seed):
    """Two 64x96 levels and ROIS rois [level, x1, y1, x2, y2] in any level
    order, 21 classes, the last 4 slots padding (roi_valid False)."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, 70, ROIS)
    y1 = rng.uniform(0, 40, ROIS)
    rois = np.stack([rng.randint(0, 2, ROIS), x1, y1,
                     x1 + rng.uniform(10, 60, ROIS),
                     y1 + rng.uniform(10, 40, ROIS)], 1).astype(np.float32)
    labels = rng.randint(0, 21, ROIS).astype(np.int32)
    targets = np.zeros((ROIS, 84), np.float32)
    inside = np.zeros_like(targets)
    for i, c in enumerate(labels):
        if c:
            targets[i, 4 * c:4 * c + 4] = rng.randn(4)
            inside[i, 4 * c:4 * c + 4] = 1.0
    valid = np.arange(ROIS) < ROIS - 4
    return {"data": (rng.rand(2, 64, 96, 3) * 255 - 128).astype(np.float32),
            "rois": rois, "labels": labels, "bbox_targets": targets,
            "bbox_inside_weights": inside,
            "bbox_outside_weights": (inside > 0).astype(np.float32),
            "roi_valid": valid}


def test_fast_rcnn_step_matches_jax():
    """One step from the same params on JAX's dropout masks. Compared: the
    loss and its two terms within 2e-6 relative; frozen conv1/conv2
    unchanged bit for bit in both packages; each trained layer's update
    and momentum (the first step's gradient) against JAX's, the fc layers
    elementwise within 1e-4 of the largest |JAX value| (float32 sums in
    another order), the trunk convs within 1e-2 in relative norm (a
    pre-activation within rounding of 0 flips its ReLU in one package and
    not the other, which moves the gradient of the layers below it)."""
    np_params = he_normal_params_2d(5, fc_dim=FC)
    batch = _batch(3)
    key = jax.random.PRNGKey(21)
    step_j, tx = J2.build_fast_rcnn_train_step(
        2, (64, 96), rois_per_batch=ROIS, n_classes=21)
    jp = jax.tree.map(jnp.asarray, np_params)
    jp, js, mj = step_j(jp, tx.init(jp), batch, key)

    params = params_from_jax(np_params, device="cpu")
    step_t, make_opt = T2.build_fast_rcnn_train_step()
    opt, sched = make_opt(params)
    mt = step_t(params, opt, sched, batch, {"drop": _drop(key, ROIS, FC)})
    assert set(mt) == set(mj) == {"loss", "cross_entropy", "loss_box"}
    for name, v in mj.items():
        assert float(v) > 0
        assert float(mt[name]) == pytest.approx(float(v), rel=2e-6), name
    after = params_to_jax(params)
    trace = js[0].trace
    for name, sub in after.items():
        layer = params[name.replace("/", "__")]
        for s, a in sub.items():
            b = np.asarray(jp[name][s])
            start = np_params[name][s]
            if name in TV.FROZEN_2D:
                np.testing.assert_array_equal(a, start)
                np.testing.assert_array_equal(b, start)
                continue
            if name.startswith("rpn"):      # outside the Fast R-CNN graph
                np.testing.assert_array_equal(a, start)
                continue
            w = layer.weight if s == "weights" else layer.bias
            buf = opt.state[w]["momentum_buffer"]
            got_buf = _as_jax(layer, buf, s)
            for got, want in ((a - start, b - start),
                              (got_buf, np.asarray(trace[name][s]))):
                assert np.abs(want).max() > 0, (name, s)
                if name.startswith("conv"):
                    assert (np.linalg.norm(got - want)
                            <= 1e-2 * np.linalg.norm(want)), (name, s)
                else:
                    assert (np.abs(got - want).max()
                            <= 1e-4 * np.abs(want).max()), (name, s)
    assert sched.get_last_lr() == [0.001]


def _as_jax(layer, value, sub):
    """``value`` (a momentum buffer of layer's weight or bias) in the JAX
    package's layout, through params_to_jax."""
    out = copy.deepcopy(layer)
    with torch.no_grad():
        (out.weight if sub == "weights" else out.bias).copy_(value)
    return params_to_jax(torch.nn.ModuleDict({"x": out}))["x"][sub]


@pytest.fixture(scope="module")
def devkit(tmp_path_factory):
    """A 4-image VOC tree at 120x160 and an RPN proposal file per image:
    each gt box jittered 8 times, 8 random boxes and one degenerate row."""
    root = synthetic.generate_voc(
        str(tmp_path_factory.mktemp("voc") / "VOCdevkit"), num_images=4,
        seed=2, image_hw=(120, 160))
    rng = np.random.RandomState(4)
    voc = TVOC("trainval", "2007", root)
    d = os.path.join(root, "region_proposals", "RPN", "training")
    os.makedirs(d)
    for i, index in enumerate(voc.image_index):
        gt = voc._load_pascal_annotation(index)["boxes"].astype(np.float64)
        boxes = [g + rng.uniform(-10, 10, 4) for g in gt for _ in range(8)]
        xy = rng.uniform(0, 120, (8, 2))
        boxes += list(np.hstack([xy, xy + rng.uniform(8, 60, (8, 2))]))
        boxes.append([50, 50, 40, 60])                   # x2 < x1: dropped
        rows = np.hstack([np.clip(boxes, 0, 159), rng.rand(len(boxes), 1)])
        np.savetxt(os.path.join(d, index + ".txt"), rows, fmt="%.2f")
    return root


def _proposal_roidb(imdb):
    """The region-proposal roidb with the fields the Fast R-CNN sampler
    reads (the reference's roi_data_layer/roidb.py prepare_roidb)."""
    imdb.roidb_handler = imdb.region_proposal_roidb
    roidb = imdb.roidb
    for i, e in enumerate(roidb):
        e["image_path"] = imdb.image_path_at(i)
        e["max_classes"] = e["gt_overlaps"].argmax(axis=1)
        e["max_overlaps"] = e["gt_overlaps"].max(axis=1)
    return roidb


def test_train_net_fast_rcnn_matches_jax(devkit, tmp_path, monkeypatch):
    """Two iterations of both loops through train_net_2d with HAS_RPN off
    (2 images a batch, BATCH_SIZE 16, at lr 1e-5 from the same .npy
    weights over the same proposal roidb), the port on JAX's dropout masks
    rebuilt from train_net_fast_rcnn's key chain (PRNGKey(seed), a split for
    the init, then one split per iteration): the logged losses within 1e-4
    relative; every trained layer's move within 1e-2 of JAX's in relative
    norm, conv1/conv2 and the RPN layers unchanged; the snapshot holds
    JAX's snapshot_unnormalize_2d of the port's params, with JAX's
    per-class target stats, bit for bit."""
    for c, sub in ((jcfg, "jax"), (tcfg, "port")):
        monkeypatch.setattr(c, "ROOT_DIR", str(tmp_path / sub))
        monkeypatch.setattr(c, "DATA_DIR", str(tmp_path / sub / "data"))
        monkeypatch.setattr(c.TRAIN, "BATCH_SIZE", 16)
        monkeypatch.setattr(c.TRAIN, "LEARNING_RATE", 1e-5)
        monkeypatch.setattr(c.TRAIN, "DISPLAY", 1)
        monkeypatch.setattr(c.TRAIN, "HAS_RPN", False)
    monkeypatch.setattr(JV, "init_params_2d",
                        functools.partial(JV.init_params_2d, fc_dim=FC))
    monkeypatch.setattr(TV, "init_params_2d",
                        functools.partial(TV.init_params_2d, fc_dim=FC))
    he = str(tmp_path / "he.npy")
    np.save(he, he_normal_params_2d(7, fc_dim=FC))
    jimdb = JVOC("trainval", "2007", devkit)
    jroidb = _proposal_roidb(jimdb)
    timdb = TVOC("trainval", "2007", devkit)
    troidb = _proposal_roidb(timdb)
    for a, b in zip(jroidb, troidb):
        for k in ("boxes", "gt_classes", "gt_overlaps", "max_classes"):
            np.testing.assert_array_equal(a[k], b[k])
    from mv3d_tf_tpu.data import multiscale as JM
    means, stds = JM.add_bbox_regression_targets(copy.deepcopy(jroidb), 21)

    key = jax.random.PRNGKey(3)
    key, _ = jax.random.split(key)
    masks = []
    for _ in range(2):
        key, k = jax.random.split(key)
        masks.append(_drop(k, 16, FC))
    monkeypatch.setattr(T2, "make_draws_fast_rcnn",
                        lambda *a: {"drop": masks.pop(0)})
    kw = dict(pretrained_model=he, max_iters=2, seed=3, bucket_hw=(128, 160))
    jlogs, tlogs = [], []
    jparams = JS.train_net_2d(jimdb, jroidb, str(tmp_path / "jout"),
                              log=jlogs.append, **kw)
    params = TS.train_net_2d(timdb, troidb, str(tmp_path / "tout"),
                             log=tlogs.append, device="cpu", **kw)
    assert not masks
    losses = [[float(s.split("total loss: ")[1].split()[0]) for s in logs
               if "total loss" in s] for logs in (jlogs, tlogs)]
    assert len(losses[1]) == 2 and all(v > 0 for v in losses[1])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    start = np.load(he, allow_pickle=True).item()
    got = params_to_jax(params)
    for name, sub in got.items():
        for s, a in sub.items():
            b = np.asarray(jparams[name][s])
            if name in TV.FROZEN_2D or name.startswith("rpn"):
                np.testing.assert_array_equal(a, start[name][s])
                continue
            moved = np.linalg.norm(b - start[name][s])
            assert moved > 0, (name, s)
            assert np.linalg.norm(a - b) <= 1e-2 * moved, (name, s)

    want = J2.snapshot_unnormalize_2d(got, means, stds, 21)
    blob = torch.load(str(tmp_path / "tout" / "VGGnet_fast_rcnn_iter_2.pt"),
                      weights_only=True)["params"]
    # JAX folds in float64 numpy; its float32 net rounds once, as the port
    np.testing.assert_array_equal(
        blob["bbox_pred.weight"].numpy().T,
        np.asarray(want["bbox_pred"]["weights"], np.float32))
    np.testing.assert_array_equal(
        blob["bbox_pred.bias"].numpy(),
        np.asarray(want["bbox_pred"]["biases"], np.float32))
    assert not np.array_equal(want["bbox_pred"]["weights"],
                              got["bbox_pred"]["weights"])
    for k, v in params.state_dict().items():
        if not k.startswith("bbox_pred"):
            assert torch.equal(blob[k], v), k
