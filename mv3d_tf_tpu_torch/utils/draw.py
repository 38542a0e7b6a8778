"""Drawings for the demo (mv3d_tf_tpu/utils/draw.py), with numpy and Pillow:
headless, each function returns an (H, W, 3) uint8 image."""

import numpy as np

# the 12 edges of the (x0..x7, y0..y7, z0..z7) corner layout
# (geometry.lidar_3d_to_corners: 0-3 the bottom ring, 4-7 the top ring)
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def scale_to_255(a, min=0.0, max=2.0, dtype=np.uint8):
    """Linear rescale of [min, max] to [0, 255] (draw.py:7-10)."""
    return (((np.clip(a, min, max) - min) / float(max - min))
            * 255).astype(dtype)


def _as_pil(image):
    from PIL import Image
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return Image.fromarray(arr)


def show_image_boxes(image, boxes, color=(0, 255, 0), width=1):
    """(N, 4) [x1, y1, x2, y2] rectangles drawn on the image."""
    from PIL import ImageDraw
    im = _as_pil(image)
    dr = ImageDraw.Draw(im)
    for b in np.asarray(boxes).reshape(-1, 4):
        x1, y1, x2, y2 = [float(v) for v in b]
        dr.rectangle([min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)],
                     outline=color, width=width)
    return np.asarray(im)


def show_lidar_corners(image, corners, calib, color=(255, 64, 64), width=1):
    """(N, 24) lidar corners projected through the (4, 12) calib blob
    (P2 @ R0 @ Tr_velo2cam) and drawn as wireframe boxes on the image
    (draw.py:45-70)."""
    from PIL import ImageDraw
    im = _as_pil(image)
    dr = ImageDraw.Draw(im)
    corners = np.asarray(corners).reshape(-1, 24)
    calib = np.asarray(calib)
    mat = (calib[0].reshape(3, 4) @ calib[2].reshape(4, 3)
           @ calib[3].reshape(3, 4))
    for cnr in corners:
        img = mat @ np.vstack([cnr.reshape(3, 8), np.zeros(8)])
        img = img / np.where(np.abs(img[2]) > 1e-6, img[2], 1e-6)
        for a, b in BOX_EDGES:
            dr.line([float(img[0, a]), float(img[1, a]),
                     float(img[0, b]), float(img[1, b])],
                    fill=color, width=width)
    return np.asarray(im)


def show_bev_detections(bev, boxes_bv, scores=None, channel=8):
    """The BEV intensity channel with the detections' rectangles."""
    base = scale_to_255(np.asarray(bev)[:, :, channel], 0, 1)
    return show_image_boxes(base, boxes_bv)


def _view_matrix(azim_deg, elev_deg):
    az = np.deg2rad(azim_deg)
    el = np.deg2rad(elev_deg)
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]], np.float32)
    rx = np.array([[1, 0, 0],
                   [0, np.cos(el), -np.sin(el)],
                   [0, np.sin(el), np.cos(el)]], np.float32)
    swap = np.array([[0, -1, 0],       # camera x = -lidar y (right)
                     [0, 0, -1],       # camera y = -lidar z (down)
                     [1, 0, 0]], np.float32)  # camera z = lidar x (depth)
    return swap @ rx @ rz


def _project(pts, size, azim_deg, elev_deg, cam_pos, focal):
    h, w = size
    cam = (np.asarray(pts, np.float32) - cam_pos) @ _view_matrix(
        azim_deg, elev_deg).T
    z = np.maximum(cam[:, 2], 1e-3)
    u = focal * cam[:, 0] / z + w / 2.0
    v = focal * cam[:, 1] / z + h / 2.0
    return u, v, cam[:, 2]


def show_pointcloud_3d(scan, corner_sets=(), colors=((64, 255, 64),),
                       size=(500, 1000), azim_deg=0.0, elev_deg=-16.0,
                       cam_pos=(-14.0, 0.0, 9.0), focal=500.0):
    """A perspective render of the point cloud, shaded by height, with 3D
    box wireframes: the reference's interactive mayavi view as an image
    (draw.py:96-145). scan (N, 3 or 4) lidar points; corner_sets an
    iterable of (M, 24) corner arrays, drawn in the matching entry of
    colors (cycled)."""
    from PIL import Image, ImageDraw
    h, w = size
    img = np.zeros((h, w, 3), np.uint8)
    scan = np.asarray(scan, np.float32).reshape(-1, scan.shape[-1])
    cam_pos = np.asarray(cam_pos, np.float32)
    if len(scan):
        u, v, z = _project(scan[:, :3], size, azim_deg, elev_deg, cam_pos,
                           focal)
        ok = (z > 0.5) & (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1)
        ui, vi = u[ok].astype(np.int32), v[ok].astype(np.int32)
        shade = scale_to_255(scan[ok, 2], min=-2.0, max=1.0)
        img[vi, ui, 0] = np.maximum(img[vi, ui, 0], shade)
        img[vi, ui, 1] = np.maximum(img[vi, ui, 1], 255 - shade)
        img[vi, ui, 2] = 96

    pil = Image.fromarray(img)
    dr = ImageDraw.Draw(pil)
    for si, cnrs in enumerate(corner_sets):
        color = tuple(colors[si % len(colors)])
        for c in np.asarray(cnrs, np.float32).reshape(-1, 24):
            u, v, z = _project(c.reshape(3, 8).T, size, azim_deg, elev_deg,
                               cam_pos, focal)
            if np.any(z <= 0.5):
                continue
            for a, b in BOX_EDGES:
                dr.line([(float(u[a]), float(v[a])),
                         (float(u[b]), float(v[b]))], fill=color, width=2)
    return np.asarray(pil)
