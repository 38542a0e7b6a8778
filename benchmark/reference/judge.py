"""The comparisons shared by the detector cells: each program roi matched to
the reference's decoded anchor boxes, the NMS's ordering judged against the
reference's scores, the program's own keep set held to the greedy rule.

The program's NMS runs on its bfloat16 scores and boxes. A box whose IoU
sits at the threshold, or whose score ties another, may go either way in
bfloat16 and in float32 alike, so the reference cannot demand the program's
keep set. It demands what greedy NMS promises instead:
  * every kept box is a decoded anchor of this frame (``match``);
  * no kept box overlaps an earlier kept box by the threshold or more, in
    the program's own boxes (``overlap``);
  * each kept box scores, by the reference, no lower than the best
    candidate still free at its step (``gap``), where a candidate is free
    unless a box kept before overlaps it by the threshold less a margin
    for the boxes' rounding, and the candidates are the boxes that pass
    the layer's filters by a margin;
  * no slot is left empty while such a free candidate remains
    (``missing``).
"""

import torch

from benchmark.reference.geometry import bbox_overlaps


def match(rois, decoded, logit=None, slack=0.0):
    """rois (n, D), decoded (N, D) -> (index (n,) of the nearest decoded box
    by the largest coordinate difference, that difference (n,)). With
    ``logit``, among the decoded boxes within ``slack`` of the nearest the
    best-scoring one is taken: boxes clipped to the image can coincide, and
    greedy NMS keeps the best of coinciding boxes."""
    d = torch.cdist(rois.double(), decoded.double(), p=float("inf"))
    dist, idx = d.min(dim=1)
    if logit is not None:
        near = d <= dist[:, None] + slack
        idx = torch.where(near, logit[None, :].double(),
                          float("-inf")).argmax(1)
        dist = d.gather(1, idx[:, None])[:, 0]
    return idx, dist.float()


def overlap(boxes):
    """The largest IoU between two boxes of (n, 4); 0 for fewer than two."""
    if len(boxes) < 2:
        return 0.0
    iou = bbox_overlaps(boxes, boxes).triu(1)
    return float(iou.max())


def gap(kept, logit, boxes, candidates, pool, thresh, margin, slots):
    """Greedy NMS's promise, judged by the reference.

    kept (n,) anchor indices of the program's kept boxes in slot order;
    logit (N,) the reference's score of every anchor as a logit; boxes
    (N, 4) the reference's boxes; candidates (N,) bool the boxes that pass
    the filters with a margin; pool (N,) bool those of them that lie well
    inside the pre-NMS top-K; slots the layer's output count. Returns (gap:
    the mean over the steps of the amount by which the best free candidate
    outscores the box kept at that step (0 where none does), in units of
    the logits' standard deviation over the candidates; missing: the empty
    slots for which a free candidate within the pre-NMS pool remained).

    The mean, not the widest gap: a sound bfloat16 program's widest gap is
    the tail of its score rounding over some 4,800 steps of a pool, and
    swings from seed to seed over the control's; its mean does not.
    """
    sigma = logit[candidates].std().clamp(min=1e-12)
    n = len(kept)
    if n == 0:
        return 0.0, min(slots, int(pool.sum()))
    hit = bbox_overlaps(boxes[kept], boxes) >= thresh - margin     # (n, N)
    hit[torch.arange(n, device=kept.device), kept] = True
    before = torch.cumsum(hit.int(), 0) - hit.int()                 # (n, N)
    free = candidates[None, :] & (before == 0)
    best = torch.where(free, logit[None, :], float("-inf")).amax(1)
    g = (best - logit[kept]).clamp(min=0)
    g = torch.where(torch.isfinite(g), g, 0.0)
    left = pool & ~hit.any(0)
    missing = min(slots - n, int(left.sum()))
    return float(g.mean() / sigma), missing
