"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work could take on it, and the work of the layers the per-layer
metrics name, counted from shapes.

``bound`` and ``bin_cells_total`` are frozen copies, as of the port's first
benchmark, of chip_smoke.py:bound and :bin_cells_total: per launch the
larger of bytes (inputs read once, outputs written once) over the memory's
rate and operations over the type's peak, summed.
"""

import torch

from benchmark.reference.ops import bin_bounds

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def bound(parts, peak):
    """The least time in ms for launches given as (bytes, operations)
    pairs: per launch the larger of bytes / HBM rate and operations /
    peak, summed."""
    return sum(max(b / HBM_BYTES_PER_S, o / peak) for b, o in parts) * 1e3


def bin_cells_total(rois, H, W, scale):
    """The feature cells that the rois' 7x7 bins cover, summed over bins."""
    hs, he, ws, we = bin_bounds(rois, 7, scale, H, W).unbind(1)
    return int(((he - hs).clamp(min=0)[:, :, None]
                * (we - ws).clamp(min=0)[:, None, :]).sum())


def roi_pool_work(feat, rois, scale):
    """(bytes, operations) of one ROI max-pool launch over feat (H, W, C)
    or (B, H, W, C): each feature cell that some roi's bins cover read
    once, the pooled maps written once, the rois read once; one comparison
    per cell of each bin."""
    H, W, C = feat.shape[-3:]
    bounds = bin_bounds(rois, 7, scale, H, W)
    hs, he, ws, we = bounds.unbind(1)
    ar_h = torch.arange(H, device=rois.device)
    ar_w = torch.arange(W, device=rois.device)
    rows = (ar_h >= hs.amin(1)[:, None]) & (ar_h < he.amax(1)[:, None])
    cols = (ar_w >= ws.amin(1)[:, None]) & (ar_w < we.amax(1)[:, None])
    frame = rois[:, 0].long()
    unique = 0
    for f in frame.unique():
        m = frame == f
        unique += int((rows[m][:, :, None] & cols[m][:, None, :]).any(0).sum())
    size = feat.element_size()
    nbytes = (unique * C * size + rois.shape[0] * 49 * C * size
              + rois.numel() * rois.element_size())
    return nbytes, bin_cells_total(rois, H, W, scale) * C


# --- FLOPs of the convolutions and fully connected layers -----------------

def conv_flops(h, w, cin, cout, k):
    """2 * multiply-adds of a SAME (or 1x1) conv over an h x w map."""
    return 2 * h * w * cin * cout * k * k


def vgg16_flops(h, w, cin, stride):
    """The 13 convs of a VGG16 trunk on an h x w input, pools as the stride
    says (three at 8, four at 16); VALID pools floor the map."""
    pools = {8: ("conv1_2", "conv2_2", "conv3_3"),
             16: ("conv1_2", "conv2_2", "conv3_3", "conv4_3")}[stride]
    layers = (("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
              ("conv2_2", 128), ("conv3_1", 256), ("conv3_2", 256),
              ("conv3_3", 256), ("conv4_1", 512), ("conv4_2", 512),
              ("conv4_3", 512), ("conv5_1", 512), ("conv5_2", 512),
              ("conv5_3", 512))
    total = 0
    for name, cout in layers:
        total += conv_flops(h, w, cin, cout, 3)
        cin = cout
        if name in pools:
            h, w = h // 2, w // 2
    return total, (h, w)


def rpn_flops(h, w, anchors, box_dims):
    return (conv_flops(h, w, 512, 512, 3)
            + conv_flops(h, w, 512, anchors * 2, 1)
            + conv_flops(h, w, 512, anchors * box_dims, 1))


def mv3d_frame_flops(cfg):
    """A test-time MV3D frame: both trunks, the RPN and the fusion head over
    the post-NMS rois."""
    bev, (h, w) = vgg16_flops(*cfg["bev_hw"], cfg["bev_channels"], 8)
    img, _ = vgg16_flops(*cfg["image_hw"], 3, 8)
    rois, fc = cfg["test"]["post_nms_top_n"], cfg["fc_dim"]
    pooled = 512 * cfg["pooled"] ** 2
    head = 2 * rois * (2 * (pooled * fc + fc * fc)
                       + 2 * fc * cfg["num_classes"] * 25)
    return bev + img + rpn_flops(h, w, cfg["num_anchors"], 6) + head


def frcnn_image_flops(cfg):
    """A 2D Faster R-CNN image at the padded bucket: the trunk, the RPN and
    the head over the post-NMS rois."""
    trunk, (h, w) = vgg16_flops(*cfg["image_hw"], 3, 16)
    rois, fc = cfg["test"]["post_nms_top_n"], cfg["fc_dim"]
    k = cfg["num_classes"]
    head = 2 * rois * (512 * cfg["pooled"] ** 2 * fc + fc * fc + fc * 5 * k)
    return trunk + rpn_flops(h, w, cfg["num_anchors"], 4) + head
