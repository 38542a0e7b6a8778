"""IoU with the Fast R-CNN +1 pixel-area convention (mv3d_tf_tpu/ops/iou.py)."""

import torch


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
