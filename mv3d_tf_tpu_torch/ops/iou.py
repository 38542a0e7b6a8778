"""IoU with the Fast R-CNN +1 pixel-area convention (mv3d_tf_tpu/ops/iou.py)."""

import torch


def bbox_overlaps(boxes, query):
    """(N, 4) x (K, 4) -> (N, K) IoU, 0 where the boxes do not overlap.
    ops/iou.py:11-30."""
    b, q = boxes[:, None, :], query[None, :, :]
    iw = (torch.minimum(b[..., 2], q[..., 2])
          - torch.maximum(b[..., 0], q[..., 0]) + 1.0)
    ih = (torch.minimum(b[..., 3], q[..., 3])
          - torch.maximum(b[..., 1], q[..., 1]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_b = ((boxes[:, 2] - boxes[:, 0] + 1.0)
              * (boxes[:, 3] - boxes[:, 1] + 1.0))[:, None]
    area_q = ((query[:, 2] - query[:, 0] + 1.0)
              * (query[:, 3] - query[:, 1] + 1.0))[None, :]
    iou = inter / (area_b + area_q - inter)
    return torch.where((iw > 0.0) & (ih > 0.0), iou, 0.0)


def iou_one_to_many(box, boxes):
    """IoU of (..., 4) boxes against (..., N, 4) boxes -> (..., N).
    ops/iou.py:32-43; the leading dims of ``box`` broadcast over N."""
    box = box.unsqueeze(-2)
    iw = (torch.minimum(box[..., 2], boxes[..., 2])
          - torch.maximum(box[..., 0], boxes[..., 0]) + 1.0)
    ih = (torch.minimum(box[..., 3], boxes[..., 3])
          - torch.maximum(box[..., 1], boxes[..., 1]) + 1.0)
    inter = iw.clamp(min=0.0) * ih.clamp(min=0.0)
    area_a = (box[..., 2] - box[..., 0] + 1.0) * (box[..., 3] - box[..., 1] + 1.0)
    area_b = ((boxes[..., 2] - boxes[..., 0] + 1.0)
              * (boxes[..., 3] - boxes[..., 1] + 1.0))
    return inter / (area_a + area_b - inter)
