"""The port's spans and counters (mv3d_tf_tpu_torch/trace.py) on the CPU at
tests/test_torch_eval.py's small shapes: off, a span is one shared null
context that records nothing and enters no record_function; on, the
detectors give their span trees (names, parents, one request a root,
children inside their parent), the same tree as torch.profiler events;
host_syncs and nms_rounds count what they name, the rounds recounted by
plain loops."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch import faster_rcnn_2d as F2  # noqa: E402
from mv3d_tf_tpu_torch import trace as T  # noqa: E402
from mv3d_tf_tpu_torch.eval import (build_detect_batch_fn,  # noqa: E402
                                    build_detect_fn, frame_detections)
from mv3d_tf_tpu_torch.models import mv3d, vggnet  # noqa: E402
from mv3d_tf_tpu_torch.ops import nms as N  # noqa: E402
from mv3d_tf_tpu_torch.ops.bev import (pad_points,  # noqa: E402
                                       point_cloud_2_top_batch)
from mv3d_tf_tpu_torch.ops.iou import bbox_overlaps  # noqa: E402

SMALL = dict(feat_h=10, feat_w=10, pre_nms_top_n=120, post_nms_top_n=40)
DETECT_TREE = {
    "detect": None, "detect.inputs": "detect", "detect.trunks": "detect",
    "detect.rpn": "detect", "detect.proposals": "detect",
    "detect.proposals.nms": "detect.proposals", "detect.roi_pool": "detect",
    "detect.head": "detect"}
ASSEMBLY_TREE = {"assembly": None, "assembly.to_host": "assembly"}
TREE_2D = {
    "im_detect_2d": None, "im_detect_2d.inputs": "im_detect_2d",
    "im_detect_2d.trunk": "im_detect_2d", "im_detect_2d.rpn": "im_detect_2d",
    "im_detect_2d.proposals": "im_detect_2d",
    "im_detect_2d.proposals.nms": "im_detect_2d.proposals",
    "im_detect_2d.roi_pool": "im_detect_2d",
    "im_detect_2d.head": "im_detect_2d"}


@pytest.fixture(autouse=True)
def fresh():
    """Tracing off and no records before and after each test."""
    T.disable()
    T.clear()
    yield
    T.disable()
    T.clear()


@pytest.fixture(scope="module")
def params():
    return mv3d.init_params(torch.Generator().manual_seed(0), fc_dim=16,
                            device="cpu")


def _frames(b):
    rng = np.random.RandomState(3)
    bev = rng.rand(b, 81, 81, 9).astype(np.float32)
    img = (rng.rand(b, 88, 120, 3) * 255).astype(np.float32)
    cal = np.zeros((4, 12), np.float32)
    cal[0, [0, 5, 10]] = 1
    cal[2, [0, 4, 8]] = 1
    cal[3, [1, 6, 8]] = [-1, -1, 1]
    return bev, img, np.repeat(cal[None], b, 0)


def _tree(recs):
    """{name: parent's name} of the records, checking that each name occurs
    once, every child lies inside its parent and shares its request, and
    every root has a request of its own."""
    by_id = {r.id: r for r in recs}
    tree = {}
    for r in recs:
        assert r.name not in tree
        assert r.start_ns <= r.end_ns
        if r.parent is None:
            tree[r.name] = None
        else:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert r.request == p.request
            tree[r.name] = p.name
    roots = [r.request for r in recs if r.parent is None]
    assert len(set(roots)) == len(roots)
    return tree


def _by_request(recs):
    out = {}
    for r in recs:
        out.setdefault(r.request, []).append(r)
    return list(out.values())


def test_off_is_one_null_context_that_records_nothing(params, monkeypatch):
    """Off: every span is the one shared null context; the detectors and
    the assembly enter no record_function, record nothing, and put no
    event named after a span into a running profiler."""
    assert not T.enabled()
    assert T.span("a") is T.span("b")
    assert isinstance(T.span("a"), contextlib.nullcontext)
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    bev, img, cal = _frames(2)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        det = build_detect_batch_fn(**SMALL)(params, bev, img, cal)
        frame_detections({k: v[0] for k, v in det.items()})
    assert entered == [] and T.records() == []
    names = set(DETECT_TREE) | set(ASSEMBLY_TREE)
    assert not names & {e.name for e in prof.events()}


def test_tracing_context_restores_the_switch():
    with T.tracing():
        assert T.enabled()
        with T.tracing():
            assert T.enabled()
        assert T.enabled()
    assert not T.enabled()
    T.enable()
    with T.tracing():
        pass
    assert T.enabled()


def test_batch_detector_span_tree(params):
    bev, img, cal = _frames(2)
    detect = build_detect_batch_fn(**SMALL)
    with T.tracing():
        det = detect(params, bev, img, cal)
        for j in range(2):
            frame_detections({k: v[j] for k, v in det.items()})
    requests = _by_request(T.records())
    assert len(requests) == 3
    assert _tree(requests[0]) == DETECT_TREE
    for recs in requests[1:]:
        assert _tree(recs) == ASSEMBLY_TREE


def test_single_frame_detector_span_tree(params):
    bev, img, cal = _frames(1)
    with T.tracing():
        det = build_detect_fn(**SMALL)(params, bev[0], img[0], cal[0])
        frame_detections(det)
    detect, assembly = _by_request(T.records())
    assert _tree(detect) == DETECT_TREE
    assert _tree(assembly) == ASSEMBLY_TREE
    # the root's children cover it but for the glue between them
    root = next(r for r in detect if r.parent is None)
    kids = sum(r.end_ns - r.start_ns for r in detect if r.parent == root.id)
    assert kids <= root.end_ns - root.start_ns


def test_front_end_spans_are_roots():
    rng = np.random.RandomState(0)
    scan = (rng.rand(500, 4) * [40, 40, 3, 1] - [0, 20, 2, 0]).astype(
        np.float32)
    with T.tracing():
        pts, valid = pad_points(scan, 1024)
        point_cloud_2_top_batch(pts[None], valid[None], device="cpu")
    recs = T.records()
    assert [(r.name, r.parent) for r in recs] == [("bev.pad", None),
                                                  ("bev.raster", None)]
    assert recs[0].request != recs[1].request


def test_frame_detections_counts_one_sync_per_tensor(params):
    bev, img, cal = _frames(1)
    det = build_detect_fn(**SMALL)(params, bev[0], img[0], cal[0])
    det["extra"] = np.zeros(3)             # a host array is no sync
    before = T.host_syncs
    frame_detections(det)
    assert T.host_syncs - before == sum(torch.is_tensor(v)
                                        for v in det.values()) == 7


def _chain_boxes(rng, n_chain=12, n_rand=40):
    """A suppression chain (each box overlaps the next by IoU 0.82 and the
    one after by 0.67, scores falling along it), so a fixpoint takes many
    rounds, and random boxes around it; some entries invalid."""
    x = 10.0 * np.arange(n_chain)
    chain = np.stack([x, np.zeros_like(x), x + 99, np.full_like(x, 49)], 1)
    xy = rng.rand(n_rand, 2) * 300
    wh = rng.rand(n_rand, 2) * 60 + 10
    rand = np.concatenate([xy, xy + wh], 1)
    boxes = np.concatenate([chain, rand]).astype(np.float32)
    scores = np.concatenate([1.0 - 0.01 * np.arange(n_chain),
                             rng.rand(n_rand) * 0.8]).astype(np.float32)
    valid = np.ones(len(boxes), bool)
    valid[-3:] = False
    perm = rng.permutation(len(boxes))
    return (torch.from_numpy(boxes[perm]), torch.from_numpy(scores[perm]),
            torch.from_numpy(valid[perm]))


def _fixpoint_rounds(sup, valid):
    """Rounds of kept <- valid & no kept earlier box suppresses it, from
    kept = valid, up to and including the round that changes nothing;
    and the kept mask."""
    kept, rounds = valid.copy(), 0
    while True:
        rounds += 1
        new = valid & ~(kept[:, None] & sup).any(0)
        if (new == kept).all():
            return rounds, kept
        kept = new


def _sorted(boxes, scores, valid):
    order = np.argsort(-np.where(valid, scores.numpy(), -np.inf),
                       kind="stable")
    return boxes[order], valid.numpy()[order]


def _sup(a, b, thr):
    return (bbox_overlaps(a, b) >= thr).numpy()


def test_nms_matrix_counts_its_rounds():
    boxes, scores, valid = _chain_boxes(np.random.RandomState(0))
    bs, vs = _sorted(boxes, scores, valid)
    sup = np.triu(_sup(bs, bs, 0.7), 1) & vs[:, None] & vs[None, :]
    want, _ = _fixpoint_rounds(sup, vs)
    assert want >= 6
    r0, s0 = T.nms_rounds, T.host_syncs
    N.nms_matrix(boxes, scores, valid, 20, 0.7)
    assert T.nms_rounds - r0 == want
    assert T.host_syncs - s0 == want


def _blocked_rounds(boxes, scores, valid, block, thr):
    """nms_blocked's rounds by a plain loop: each block's fixpoint on the
    boxes that earlier blocks' kept boxes left, then its kept boxes
    suppress those behind it."""
    bs, vs = _sorted(boxes, scores, valid)
    supp = np.zeros(len(bs), bool)
    total = 0
    for start in range(0, len(bs), block):
        end = min(start + block, len(bs))
        bb = bs[start:end]
        bvalid = vs[start:end] & ~supp[start:end]
        sup = (np.triu(_sup(bb, bb, thr), 1) & bvalid[:, None]
               & bvalid[None, :])
        rounds, kept = _fixpoint_rounds(sup, bvalid)
        total += rounds
        if end < len(bs):
            supp[end:] |= (kept[:, None] & _sup(bb, bs[end:], thr)).any(0)
    return total


def test_nms_blocked_counts_its_rounds():
    boxes, scores, valid = _chain_boxes(np.random.RandomState(1))
    want = _blocked_rounds(boxes, scores, valid, 16, 0.7)
    r0, s0 = T.nms_rounds, T.host_syncs
    N.nms_blocked(boxes, scores, valid, 20, 0.7, block=16)
    assert T.nms_rounds - r0 == want
    assert T.host_syncs - s0 == want
    # the fixed variant runs its rounds in every block and never syncs
    r0, s0 = T.nms_rounds, T.host_syncs
    N.nms_blocked_fixed(boxes, scores, valid, 20, 0.7, block=16, rounds=5)
    assert T.nms_rounds - r0 == 5 * -(-len(boxes) // 16)
    assert T.host_syncs == s0


@pytest.fixture(scope="module")
def params_2d():
    return vggnet.init_params_2d(torch.Generator().manual_seed(0), fc_dim=16,
                                 device="cpu")


def test_im_detect_2d_span_tree(params_2d):
    h, w = 4, 5
    rng = np.random.RandomState(0)
    image = (rng.rand(16 * h, 16 * w, 3) * 255 - 128).astype(np.float32)
    info = np.array([16 * h, 16 * w, 1.0], np.float32)
    detect = F2.build_im_detect_2d(h, w, pre_nms_top_n=50, post_nms_top_n=10)
    r0 = T.nms_rounds
    with T.tracing():
        detect(params_2d, image, info)
    recs = T.records()
    assert _tree(recs) == TREE_2D
    nms = next(r for r in recs if r.name == "im_detect_2d.proposals.nms")
    assert nms.counts["nms_rounds"] == T.nms_rounds - r0 >= 1
    assert nms.counts["host_syncs"] == nms.counts["nms_rounds"]


def test_spans_are_profiler_events_with_the_same_parents(params):
    bev, img, cal = _frames(1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with T.tracing():
            det = build_detect_fn(**SMALL)(params, bev[0], img[0], cal[0])
            frame_detections(det)
    names = set(DETECT_TREE) | set(ASSEMBLY_TREE)
    events = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in events) == sorted(names)
    got = {e.name: e.cpu_parent.name if e.cpu_parent is not None else None
           for e in events}
    assert got == {**DETECT_TREE, **ASSEMBLY_TREE}
    assert got == _tree(T.records())
