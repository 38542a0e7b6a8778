"""The greedy NMS kernel (csrc/nms.cu, ops/nms_cuda.py) and the dispatch of
ops/nms.py:nms. On the CPU: the wrapper refuses CPU tensors, nms takes
nms_plain there without a launch, the C entries and __global__ functions
are named where the build and the traces look for them, and the counter is
reported. On a card (marker ``card``): keep_idx and keep_valid equal to
nms_plain's bit for bit on CUDA tensors, presorted and not.

This file imports neither JAX nor the JAX package, so that it runs on the
card's machine, which has neither; there, without tests/conftest.py:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nms_cuda.py
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mv3d_tf_tpu_torch import kernels  # noqa: E402
from mv3d_tf_tpu_torch import trace  # noqa: E402
from mv3d_tf_tpu_torch.ops import nms as N  # noqa: E402
from mv3d_tf_tpu_torch.ops import nms_cuda as C  # noqa: E402
from mv3d_tf_tpu_torch.ops.iou import iou_one_to_many  # noqa: E402

SOURCE = os.path.join(os.path.dirname(C.__file__), os.pardir, "csrc",
                      "nms.cu")
ENTRIES = ("mv3d_nms_mask_f32", "mv3d_nms_scan")
THRESH = 0.7


def _boxes(rng, b, n, size=600.0, lo=4.0, hi=40.0):
    xy = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(lo, hi, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _bev_frames(rng, b, n=6000):
    """Proposal-like BEV candidates: 3-8 clusters of car-sized boxes
    jittered by a few pixels (so greedy suppression chains through them)
    among boxes spread over the 601 x 601 raster, some invalid."""
    boxes = _boxes(rng, b, n, lo=8.0, hi=45.0)
    for f in range(b):
        at = 0
        for _ in range(rng.randint(3, 9)):
            m = min(rng.randint(200, 500), n - at)
            c = rng.uniform(50, 550, 2)
            wh = rng.uniform([15, 30], [20, 45])
            jit = rng.normal(0, 3, (m, 4))
            boxes[f, at:at + m] = np.concatenate([c - wh / 2, c + wh / 2]) + jit
            at += m
    scores = rng.rand(b, n).astype(np.float32)
    valid = rng.rand(b, n) > 0.1
    return boxes.astype(np.float32), scores, valid


def _presort(boxes, scores, valid):
    """What presorted promises: the valid candidates by descending score,
    ties by index (ops/nms.py:top_k_by_score's order)."""
    key = np.where(valid & np.isfinite(scores), scores, -np.inf)
    order = np.argsort(-key, axis=-1, kind="stable")
    return (np.take_along_axis(boxes, order[..., None], -2),
            np.take_along_axis(scores, order, -1),
            np.take_along_axis(valid, order, -1))


def _chains(n_chains, length, gap=600.0):
    """Chains of boxes 100 wide, each 12 px right of the last: neighbours at
    IoU 0.786, two apart at 0.613, so greedy keeps every other one."""
    x = 12.0 * np.arange(length, dtype=np.float32)
    rows = [np.stack([x, np.full(length, gap * k), x + 99.0,
                      np.full(length, gap * k + 99.0)], 1)
            for k in range(n_chains)]
    return np.concatenate(rows)[None].astype(np.float32)


def near_threshold_pairs(count, thresh=THRESH, seed=0):
    """``count`` pairs each of boxes whose IoU, as ops/iou.py:
    iou_one_to_many computes it in float32 with the first as ``box``, is
    one ulp below, at and one ulp above float32(thresh): (boxes (6 count,
    4) float32, each pair's IoU). A pair is a box and the same box shifted
    by about the dx of IoU (L - dx) / (L + dx) = thresh, on a grid of 1/256
    px; the pairs lie 150 px apart, shifted by whole pixels, which keeps
    every coordinate, difference and so IoU exact."""
    rng = np.random.RandomState(seed)
    t = np.float32(thresh)
    want = [np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))]
    k = 1 << 20

    def grid(x):
        return (np.round(x * 256) / 256).astype(np.float32)

    L, H = grid(rng.uniform(20, 60, k)), grid(rng.uniform(10, 40, k))
    dx = grid(L * (1 - thresh) / (1 + thresh) + rng.uniform(-0.02, 0.02, k))
    x0, y0 = grid(rng.uniform(0, 40, k)), grid(rng.uniform(0, 40, k))
    a = np.stack([x0, y0, x0 + L - 1, y0 + H - 1], 1)
    b = a + dx[:, None] * np.array([1, 0, 1, 0], np.float32)
    iou = iou_one_to_many(torch.from_numpy(a), torch.from_numpy(b)[:, None])
    iou = iou[:, 0].numpy()
    picked = np.concatenate([np.nonzero(iou == w)[0][:count] for w in want])
    assert len(picked) == 3 * count
    at = np.arange(3 * count, dtype=np.float32)
    shift = np.stack([at % 16, at // 16, at % 16, at // 16], 1) * 150
    boxes = np.stack([a[picked] + shift, b[picked] + shift], 1)
    return boxes.reshape(-1, 4).astype(np.float32), iou[picked]


# -- on the CPU --------------------------------------------------------------

def test_kernel_refuses_cpu_tensors():
    rng = np.random.RandomState(0)
    boxes = torch.from_numpy(_boxes(rng, 1, 10))
    with pytest.raises(ValueError, match="CUDA"):
        C.nms_greedy_cuda(boxes, torch.rand(1, 10),
                          torch.ones(1, 10, dtype=torch.bool), 4)


@pytest.mark.parametrize("thresh", [0.0, -0.5, float("nan")])
def test_kernel_refuses_thresholds_not_positive(thresh):
    """The kernel skips the division where the intersection is 0, which
    holds only above 0."""
    boxes = torch.from_numpy(_boxes(np.random.RandomState(0), 1, 10))
    with pytest.raises(ValueError, match="positive"):
        C.nms_greedy_cuda(boxes, torch.rand(1, 10),
                          torch.ones(1, 10, dtype=torch.bool), 4, thresh)


@pytest.mark.parametrize("presorted", [False, True])
def test_nms_on_cpu_is_nms_plain_without_a_launch(presorted):
    rng = np.random.RandomState(1)
    boxes, scores, valid = _presort(*_bev_frames(rng, 2, 500))
    args = (torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(valid), 60, THRESH)
    before = C.nms_greedy_cuda.launches
    idx, val = N.nms(*args, presorted=presorted)
    assert C.nms_greedy_cuda.launches == before
    want_idx, want_val = N.nms_plain(*args)
    assert torch.equal(idx, want_idx) and torch.equal(val, want_val)
    assert val.sum() > 60


def test_nms_refuses_other_devices():
    boxes = torch.empty(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="meta"):
        N.nms(boxes, torch.empty(1, 8, device="meta"),
              torch.empty(1, 8, dtype=torch.bool, device="meta"), 4)


def test_entries_and_symbols_are_named():
    """kernels._SIGNATURES has both C entries, with one ctypes type per C
    parameter, and kernel_symbols() (how a trace names the hand kernels)
    both __global__ functions; the kernel's NEG_INF is ops/nms.py's."""
    src = open(SOURCE).read()
    for entry in ENTRIES:
        params = re.search(r"int %s\(([^)]*)\)" % entry, src).group(1)
        assert params.count(",") + 1 == len(kernels._SIGNATURES[entry])
    assert {"nms_mask_f32", "nms_scan"} <= set(kernels.kernel_symbols())
    neg = re.findall(r"constexpr float NEG_INF = ([-0-9.e]+)f;", src)
    assert [float(v) for v in neg] == [N.NEG_INF]


def test_counter_is_reported():
    counts = trace.counters()
    assert counts["nms_greedy_cuda"] == C.nms_greedy_cuda.launches


def test_near_threshold_pairs_straddle_the_threshold():
    """The card test's pairs: a third each one ulp below, at and one ulp
    above float32(0.7), their IoUs unchanged where they lie, so the plain
    loop suppresses the second box of two pairs in three."""
    boxes, iou = near_threshold_pairs(8)
    t = np.float32(THRESH)
    assert (iou < t).sum() == 8 and (iou == t).sum() == 8
    assert (iou > t).sum() == 8
    pairs = torch.from_numpy(boxes).reshape(-1, 2, 4)
    assert np.array_equal(
        iou_one_to_many(pairs[:, 0], pairs[:, 1:])[:, 0].numpy(), iou)
    n = len(boxes)
    scores = np.linspace(1, 0, n, dtype=np.float32)
    idx, val = N.nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                           torch.ones(n, dtype=torch.bool), n, THRESH)
    assert int(val.sum()) == n // 2 + 8


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds and runs only there")
    return torch.device("cuda")


def _same_as_plain(cuda, boxes, scores, valid, max_out, presorted,
                   thresh=THRESH):
    """The kernel through nms against nms_plain, both on CUDA tensors."""
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (boxes, scores, valid)]
    before = C.nms_greedy_cuda.launches
    idx, val = N.nms(*args, max_out, thresh, presorted=presorted)
    assert C.nms_greedy_cuda.launches == before + 2
    want_idx, want_val = N.nms_plain(*args, max_out, thresh)
    torch.cuda.synchronize()
    assert idx.dtype == torch.int64 and val.dtype == torch.bool
    assert torch.equal(val, want_val)
    assert torch.equal(idx, want_idx)
    return int(val.sum())


@pytest.mark.card
@pytest.mark.parametrize("b", [8, 1])
@pytest.mark.parametrize("presorted", [True, False])
def test_card_detector_shapes(cuda, b, presorted):
    data = _bev_frames(np.random.RandomState(10 + b), b)
    if presorted:
        data = _presort(*data)
    kept = _same_as_plain(cuda, *data, 300, presorted)
    assert kept == 300 * b


@pytest.mark.card
@pytest.mark.parametrize("n", [6001, 63, 1])
@pytest.mark.parametrize("presorted", [True, False])
def test_card_ragged_n(cuda, n, presorted):
    data = _bev_frames(np.random.RandomState(n), 2, n)
    if presorted:
        data = _presort(*data)
    _same_as_plain(cuda, *data, 300, presorted)


@pytest.mark.card
def test_card_all_invalid(cuda):
    boxes, scores, valid = _bev_frames(np.random.RandomState(2), 2, 700)
    assert _same_as_plain(cuda, boxes, scores, valid & False, 300,
                          False) == 0
    # non-finite scores and scores at ops/nms.py's NEG_INF are not live
    scores[0, ::2] = np.nan
    scores[0, 1::2] = np.inf
    scores[1] = np.float32(N.NEG_INF)
    assert _same_as_plain(cuda, boxes, scores, valid, 300, False) == 0


@pytest.mark.card
@pytest.mark.parametrize("presorted", [True, False])
def test_card_tied_scores(cuda, presorted):
    boxes, _, valid = _bev_frames(np.random.RandomState(3), 3, 2000)
    scores = np.full(valid.shape, 0.5, np.float32)
    scores[1, ::3] = 0.25
    data = (boxes, scores, valid)
    if presorted:
        data = _presort(*data)
    _same_as_plain(cuda, *data, 300, presorted)


@pytest.mark.card
@pytest.mark.parametrize("presorted", [True, False])
def test_card_suppression_chains(cuda, presorted):
    boxes = _chains(12, 40)
    n = boxes.shape[1]
    scores = np.linspace(1, 0, n, dtype=np.float32)[None]
    if not presorted:
        scores = scores[:, ::-1].copy()
        boxes = boxes[:, ::-1].copy()
    valid = np.ones((1, n), bool)
    assert _same_as_plain(cuda, boxes, scores, valid, 300,
                          presorted) == 12 * 20


@pytest.mark.card
def test_card_max_out_above_keeps(cuda):
    boxes, scores, valid = _presort(*_bev_frames(np.random.RandomState(4), 2,
                                                 600))
    kept = _same_as_plain(cuda, boxes, scores, valid, 700, True)
    assert 0 < kept < 2 * 600


@pytest.mark.card
@pytest.mark.parametrize("presorted", [True, False])
def test_card_iou_within_one_ulp_of_the_threshold(cuda, presorted):
    boxes, iou = near_threshold_pairs(40)
    n = len(boxes)
    scores = np.linspace(1, 0, n, dtype=np.float32)
    kept = _same_as_plain(cuda, boxes[None], scores[None],
                          np.ones((1, n), bool), n, presorted)
    assert kept == n // 2 + int((iou < np.float32(THRESH)).sum())


@pytest.mark.card
@pytest.mark.parametrize("thresh", [THRESH, 0.3, 1e-30])
def test_card_degenerate_boxes(cuda, thresh):
    """A box whose IoU with itself is below the threshold (x2 < x1) is kept
    again in every later slot, as the loop's argmax keeps taking it; boxes
    with NaN and infinite coordinates, down to a threshold that any
    overlap reaches."""
    rng = np.random.RandomState(5)
    boxes, scores, valid = _bev_frames(rng, 3, 300)
    boxes[0, 7] = [100, 100, 90, 90]
    scores[0, 7] = 0.5
    odd = rng.rand(2, 300, 4) < 0.05
    boxes[1:][odd] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0],
                                         np.float32), odd.sum())
    _same_as_plain(cuda, boxes, scores, valid, 100, False, thresh)
