"""Score top-K and exact greedy NMS with fixed output slots
(mv3d_tf_tpu/ops/nms.py), plus the numpy greedy oracle for host code.

Two formulations give the greedy keep set, as in the JAX package:
  * ``nms``: the greedy keep set, dispatched by device: on the card
    ``ops/nms_cuda.nms_greedy_cuda`` (csrc/nms.cu, two launches a call),
    on the CPU ``nms_plain``, the greedy loop, one O(N) step per output
    slot;
  * ``nms_blocked`` / ``nms_blocked_fixed``: the candidates in score order,
    512 a block; each block is resolved by a fixpoint on its (512, 512)
    suppression mask, then one (512, N) IoU sweep suppresses the boxes
    behind it. On the CPU the proposal layer takes them above post-NMS
    512 for speed (proposals.nms_route, which the 2D and 3D proposal
    layers share): a train step's 2000 greedy steps become 24 blocks. On
    the card the greedy kernel is faster at any size.
  * ``nms_matrix``: the whole (N, N) suppression mask built once, then a
    fixpoint of mask products (one host sync a round). No path of the port
    runs it any more: it stays as the port of the JAX package's matrix
    formulation, which the JAX 2D proposal layer runs.
``nms_np`` and ``nms_new_np`` are the host loops (utils/native.nms_np_native
is ``nms_np`` in C++).
"""

import numpy as np
import torch

from mv3d_tf_tpu_torch import trace as T
from mv3d_tf_tpu_torch.ops.iou import bbox_overlaps, iou_one_to_many
from mv3d_tf_tpu_torch.ops.nms_cuda import nms_greedy_cuda

NEG_INF = -1e30


def top_k_by_score(scores, valid, k):
    """Score-ordered top-k over the last dim with validity propagation
    (ops/nms.py:316-321). A stable descending sort, so ties go to the lower
    index as in ``lax.top_k``; ``torch.topk`` promises no order among ties.
    Returns (idx (..., k) int64, valid (..., k) bool)."""
    masked = torch.where(valid, scores, NEG_INF)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], vals[..., :k] > NEG_INF


def nms(boxes, scores, valid, max_out, iou_threshold=0.7, presorted=False):
    """Greedy NMS with static output slots (ops/nms.py:224-260): the kernel
    for CUDA tensors, ``nms_plain`` for CPU tensors; any other device
    raises. presorted=True promises the valid candidates in descending
    score order, as ``nms_blocked`` takes it; the kernel then skips its
    sort, and the loop, which takes the highest score wherever it is,
    needs no order. Returns keep_idx (..., max_out) int64 (0 in unused
    slots) and keep_valid (..., max_out) bool."""
    if boxes.is_cuda:
        return nms_greedy_cuda(boxes, scores, valid, max_out, iou_threshold,
                               presorted=presorted)
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, valid, max_out, iou_threshold)
    raise ValueError("nms: no greedy NMS for device " + str(boxes.device))


def nms_plain(boxes, scores, valid, max_out, iou_threshold=0.7):
    """The greedy loop, the kernel's plain version (ops/nms.py:224-260).

    boxes (..., N, 4), scores (..., N), valid (..., N) bool; leading dims
    are independent frames. Each of the max_out steps takes the first
    index of the highest remaining score and suppresses every box with
    IoU >= iou_threshold, itself included. Returns keep_idx (..., max_out)
    int64 (0 in unused slots) and keep_valid (..., max_out) bool.
    """
    msk = torch.where(valid & torch.isfinite(scores), scores, NEG_INF)
    keep_idx, keep_val = [], []
    for _ in range(max_out):
        best = msk.argmax(dim=-1, keepdim=True)              # first max
        found = msk.gather(-1, best) > NEG_INF
        best_box = boxes.gather(-2, best[..., None].expand(best.shape + (4,)))
        iou = iou_one_to_many(best_box[..., 0, :], boxes)
        msk = msk.masked_fill(found & (iou >= iou_threshold), NEG_INF)
        keep_idx.append(torch.where(found, best, 0))
        keep_val.append(found)
    return torch.cat(keep_idx, dim=-1), torch.cat(keep_val, dim=-1)


def nms_blocked(boxes, scores, valid, max_out, iou_threshold=0.7,
                block=512, presorted=False):
    """Exact greedy NMS over score-sorted blocks (ops/nms.py:115-137): each
    block's fixpoint runs until one more round changes nothing in any
    frame (one host sync a round).

    boxes (..., N, 4), scores (..., N), valid (..., N) bool; leading dims
    are independent frames. presorted=True promises boxes already in
    descending score order with every invalid entry trailing (what
    top_k_by_score gives), and skips the sort. Returns keep_idx (...,
    max_out) int64 (0 in unused slots) and keep_valid (..., max_out) bool,
    as ``nms``.
    """
    keep_idx, keep_valid, _ = _nms_blocked_core(
        boxes, scores, valid, max_out, iou_threshold, block, presorted, None)
    return keep_idx, keep_valid


def nms_blocked_fixed(boxes, scores, valid, max_out, iou_threshold=0.7,
                      block=512, presorted=False, rounds=16):
    """nms_blocked with ``rounds`` fixpoint rounds per block and no host
    sync (ops/nms.py:83-111). The keep set is the greedy one whenever every
    suppression chain inside a block is at most ``rounds`` deep; the third
    output, ``converged`` (...,) bool, certifies it: True iff one more round
    would change nothing in any block of the frame (ops/nms.py:200-205)."""
    return _nms_blocked_core(boxes, scores, valid, max_out, iou_threshold,
                             block, presorted, rounds)


def _nms_blocked_core(boxes, scores, valid, max_out, iou_threshold, block,
                      presorted, rounds):
    """The shared body (ops/nms.py:140-220), batched over frames. rounds
    None runs each block's fixpoint to the end (converged all True);
    rounds=int runs that many rounds and certifies the result."""
    lead = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4).float()
    scores = scores.reshape(-1, n)
    active = valid.reshape(-1, n) & torch.isfinite(scores)
    B, dev = scores.shape[0], scores.device
    bs = min(block, n)
    nblk = -(-n // bs)
    pad = nblk * bs - n

    if presorted:
        order = torch.arange(n, device=dev).expand(B, n)
        boxes_s, valid_s = boxes, active
    else:
        masked = torch.where(active, scores, NEG_INF)
        # descending and stable: ties keep their index order, as the
        # ascending stable argsort of the negated scores does in JAX
        order = torch.sort(masked, dim=-1, descending=True, stable=True)[1]
        boxes_s = boxes.gather(1, order[..., None].expand(B, n, 4))
        valid_s = active.gather(1, order)
    boxes_s = torch.nn.functional.pad(boxes_s, (0, 0, 0, pad))
    valid_s = torch.nn.functional.pad(valid_s, (0, pad))

    upper = torch.ones(bs, bs, dtype=torch.bool, device=dev).triu(1)
    supp = torch.zeros(B, nblk * bs, dtype=torch.bool, device=dev)
    converged = torch.ones(B, dtype=torch.bool, device=dev)
    kept_blocks = []
    for start in range(0, nblk * bs, bs):
        end = start + bs
        bb = boxes_s[:, start:end]
        bvalid = valid_s[:, start:end] & ~supp[:, start:end]
        # the block's own greedy: a fixpoint on its (bs, bs) mask
        sup_bb = ((bbox_overlaps(bb, bb) >= iou_threshold) & upper
                  & bvalid[:, :, None] & bvalid[:, None, :])

        def step(kept):
            return bvalid & ~(kept[:, :, None] & sup_bb).any(dim=1)

        kept = bvalid
        if rounds is None:
            while True:
                new = step(kept)
                T.nms_rounds += 1
                T.host_syncs += 1
                if torch.equal(new, kept):
                    break
                kept = new
        else:
            for _ in range(rounds):
                kept = step(kept)
            T.nms_rounds += rounds
            # one more round is a no-op <=> the fixpoint was reached
            converged &= (step(kept) == kept).all(dim=1)
        kept_blocks.append(kept)
        # the block's kept boxes suppress the boxes behind it; JAX sweeps
        # all N columns, but those up to ``end`` are never read again
        if end < nblk * bs:
            iou_bt = bbox_overlaps(bb, boxes_s[:, end:])
            hit = (kept[:, :, None] & (iou_bt >= iou_threshold)).any(dim=1)
            supp[:, end:] |= hit
    kept = torch.cat(kept_blocks, dim=1)[:, :n]
    keep_idx, keep_valid = _pack_kept(kept, order, max_out)
    return (keep_idx.reshape(*lead, max_out),
            keep_valid.reshape(*lead, max_out), converged.reshape(lead))


def _pack_kept(kept, order, max_out):
    """The first max_out kept boxes (kept (B, N) bool in score order;
    order (B, N) their indices) into fixed slots: keep_idx (B, max_out)
    int64, 0 in unused slots, and keep_valid (B, max_out) bool."""
    rank = kept.long().cumsum(dim=1) - 1
    slot = torch.where(kept & (rank < max_out), rank, max_out)
    keep_idx = torch.zeros(kept.shape[0], max_out + 1, dtype=torch.long,
                           device=kept.device)
    keep_idx = keep_idx.scatter(1, slot, order)[:, :max_out]
    n_kept = kept.sum(dim=1, keepdim=True).clamp(max=max_out)
    keep_valid = torch.arange(max_out, device=kept.device) < n_kept
    return keep_idx.mul(keep_valid), keep_valid


def nms_matrix(boxes, scores, valid, max_out, iou_threshold=0.7):
    """Exact greedy NMS by a fixpoint on the sorted suppression mask
    (ops/nms.py:26-80), for one frame.

    boxes (N, 4), scores (N,), valid (N,) bool. The boxes are sorted by
    score (stable, descending), the (N, N) mask "i suppresses j" (IoU >=
    iou_threshold, i < j, both valid) is built once as float32, and
      kept[j] <- valid[j] and no kept i < j suppresses j
    is iterated from kept = valid until nothing changes: one (N,) x (N, N)
    float32 product and one host sync a round. The product counts 0/1
    values, so it is exact in float32 (and in TF32, which cuBLAS uses only
    when torch.backends.cuda.matmul.allow_tf32 is set). Returns keep_idx
    (max_out,) int64 (0 in unused slots) and keep_valid (max_out,) bool.
    """
    active = valid & torch.isfinite(scores)
    masked = torch.where(active, scores, NEG_INF)
    # descending and stable: ties keep their index order, as jnp.argsort
    # of the negated scores does
    order = torch.sort(masked, descending=True, stable=True)[1]
    boxes_s = boxes.float()[order]
    valid_s = active[order]
    sup = ((bbox_overlaps(boxes_s, boxes_s) >= iou_threshold)
           .triu_(1).logical_and_(valid_s[:, None])
           .logical_and_(valid_s[None, :]).float())
    kept = valid_s
    while True:
        new = valid_s & (kept.float() @ sup < 0.5)
        T.nms_rounds += 1
        T.host_syncs += 1
        if torch.equal(new, kept):
            break
        kept = new
    keep_idx, keep_valid = _pack_kept(kept[None], order[None], max_out)
    return keep_idx[0], keep_valid[0]


def nms_np(dets, thresh):
    """Host greedy oracle with the cpu_nms.pyx semantics (ops/nms.py:263-285).
    dets: (N,5) [x1,y1,x2,y2,score] -> keep list."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    suppressed = np.zeros(dets.shape[0], bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas - inter)
        suppressed |= ovr >= thresh
    return keep


def nms_new_np(dets, thresh):
    """The reference's nms_new (ops/nms.py:288-313, lib/utils/nms.pyx:70-123):
    greedy NMS that also suppresses near-containment (intersection over
    either box's area > 0.95). dets: (N,5) [x1,y1,x2,y2,score] -> keep
    list."""
    x1, y1, x2, y2, scores = (dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3],
                              dets[:, 4])
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    suppressed = np.zeros(dets.shape[0], bool)
    keep = []
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas - inter)
        suppressed |= ((ovr >= thresh) | (inter / areas > 0.95)
                       | (inter / areas[i] > 0.95))
    return keep
