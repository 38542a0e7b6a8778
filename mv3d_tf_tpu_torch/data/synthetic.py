"""Synthetic KITTI-layout dataset generator (mv3d_tf_tpu/data/synthetic.py).

Writes a small on-disk dataset in the layout the reference expects
(kitti_mv3d.py:77-120): velodyne .bin scans, label_2 annotations, calib
files, image_2 PNGs, ImageSets splits and the lidar_bv .npy rasters, so the
evaluation entry points run end to end without real KITTI data. The draws come
from ``np.random.RandomState(seed)`` in the JAX package's order, so one seed
gives the same files from either package. Images are drawn and written with
Pillow, as the JAX package does; rasters come from the port's C++ host
raster (utils/native.point_cloud_2_top_host), bit for bit its numpy twin.

Scenes are built in the camera frame (like real labels) with cars on a
ground plane; velodyne points lie on the yawed car boxes and the ground, so
the BEV raster and the annotations agree.
"""

import os
import os.path as osp

import numpy as np

from mv3d_tf_tpu_torch import geometry_np as Gnp
from mv3d_tf_tpu_torch.utils.native import point_cloud_2_top_host

# canonical calib (velodyne x-forward -> camera z-forward, zero translation
# to match the legacy inverse transform that drops translation anyway)
P2 = np.array([[707.0493, 0.0, 604.0814, 0.0],
               [0.0, 707.0493, 180.5066, 0.0],
               [0.0, 0.0, 1.0, 0.0]], np.float32)
R0 = np.eye(3, dtype=np.float32)
TR_VELO2CAM = np.array([[0.0, -1.0, 0.0, 0.0],
                        [0.0, 0.0, -1.0, 0.0],
                        [1.0, 0.0, 0.0, 0.0]], np.float32)


def _cam_to_lidar_box(cam_box, ry):
    """Camera box -> lidar corners and 3d box through the legacy pipeline
    the label reader uses."""
    cam_cnr = Gnp.compute_corners_3d_np(cam_box, ry)
    lidar_cnr = Gnp.camera_to_lidar_cnr_np(cam_cnr, TR_VELO2CAM)[0]
    lidar_3d = Gnp.lidar_cnr_to_3d_np(lidar_cnr, cam_box[3:6])[0]
    return cam_cnr, lidar_cnr, lidar_3d


def _sample_box_points(rng, cam_box, ry, n=600):
    """Points on the yawed car box's surfaces in the lidar frame, with a
    low hood in front and a tall cabin behind, so that the raster shows the
    heading (synthetic.py:44-57)."""
    l, w, h = float(cam_box[3]), float(cam_box[4]), float(cam_box[5])
    # local frame of compute_corners_3d_np: x forward +-l/2, y 0..-h (camera
    # y points down), z +-w/2
    x = rng.uniform(-l / 2, l / 2, n).astype(np.float32)
    z = rng.uniform(-w / 2, w / 2, n).astype(np.float32)
    # push each point to one of the (end, side, top) faces
    ax = rng.randint(3, size=n)
    hi = rng.rand(n) < 0.5
    x = np.where(ax == 0, np.where(hi, l / 2, -l / 2), x).astype(np.float32)
    z = np.where(ax == 1, np.where(hi, w / 2, -w / 2), z).astype(np.float32)
    # hood: the front 40% of the car caps at 0.55h, the cabin at h
    cap = np.where(x > 0.1 * l, 0.55 * h, h).astype(np.float32)
    y = -(rng.uniform(0.0, 1.0, n).astype(np.float32) * cap)
    y = np.where(ax == 2, -cap, y).astype(np.float32)
    cos, sin = np.float32(np.cos(ry)), np.float32(np.sin(ry))
    R = np.array([[cos, 0.0, sin], [0.0, 1.0, 0.0], [-sin, 0.0, cos]],
                 np.float32)
    cam = R @ np.stack([x, y, z]) + np.asarray(
        cam_box[:3], np.float32)[:, None]
    # camera -> lidar through the legacy inverse of the corner path
    RT = Gnp._legacy_inverse_rt_np(TR_VELO2CAM)
    lidar = RT @ np.concatenate([cam, np.zeros((1, n), np.float32)])
    refl = rng.uniform(0.2, 0.9, (1, n)).astype(np.float32)
    return np.vstack([lidar, refl]).T.astype(np.float32)


def _draw_cars(rng, image_hw, cars):
    """Car patches over a noise background: a filled hull per car, far to
    near, with the front face brighter (the heading in the image view)."""
    from PIL import Image, ImageDraw
    arr = (rng.rand(*image_hw, 3) * 60 + 90).astype(np.uint8)
    im = Image.fromarray(arr)
    draw = ImageDraw.Draw(im)
    for cam_cnr, tz in sorted(cars, key=lambda c: -c[1]):
        img = Gnp.project_to_image_np(cam_cnr, P2)   # (2, 8)
        ctr = img.mean(axis=1)
        order = np.argsort(np.arctan2(img[1] - ctr[1], img[0] - ctr[0]))
        body = tuple(rng.randint(30, 80) for _ in range(3))
        draw.polygon([tuple(img[:, j]) for j in order], fill=body)
        # front face = local +x corners 0,1,5,4 (compute_corners_3d_np)
        front = img[:, [0, 1, 5, 4]]
        fctr = front.mean(axis=1)
        forder = np.argsort(
            np.arctan2(front[1] - fctr[1], front[0] - fctr[0]))
        bright = tuple(min(255, c + 120) for c in body)
        draw.polygon([tuple(front[:, j]) for j in forder], fill=bright)
    return np.asarray(im)


def _frame_labels(rng, n_cars):
    """Random plausible cars in the camera frame."""
    rows = []
    for _ in range(n_cars):
        l = rng.uniform(3.4, 4.6)
        w = rng.uniform(1.5, 1.8)
        h = rng.uniform(1.4, 1.7)
        tz = rng.uniform(8.0, 45.0)          # depth (lidar x)
        tx = rng.uniform(-0.45, 0.45) * tz * 0.5   # inside image and BEV
        ty = 1.65                            # ground in the camera frame
        ry = rng.uniform(-np.pi, np.pi)
        rows.append((tx, ty, tz, l, w, h, ry))
    return rows


def _write_png(path, arr):
    from PIL import Image
    # level 1: the noise background is deflate's worst case
    Image.fromarray(arr).save(path, compress_level=1)


def generate(root, num_frames=4, cars_per_frame=3, seed=0,
             image_hw=(375, 1242), splits=("train", "val"),
             write_bv=True, train_frac=0.5):
    """Create the dataset under <root>/ (use it as kitti_path); returns
    root. train_frac sets the train/val split point (half by default)."""
    rng = np.random.RandomState(seed)
    obj = osp.join(root, "object", "training")
    for sub in ("velodyne", "label_2", "calib", "image_2", "lidar_bv"):
        os.makedirs(osp.join(obj, sub), exist_ok=True)
    os.makedirs(osp.join(root, "ImageSets"), exist_ok=True)

    indices = [str(i).zfill(6) for i in range(num_frames)]
    for index in indices:
        labels = _frame_labels(rng, cars_per_frame)
        pts = [np.hstack([
            rng.uniform([0, -30, -1.9], [60, 30, -1.5],
                        (4000, 3)).astype(np.float32),
            rng.uniform(0.1, 0.4, (4000, 1)).astype(np.float32)])]
        lines = []
        cars = []
        for (tx, ty, tz, l, w, h, ry) in labels:
            cam_box = np.array([tx, ty, tz, l, w, h], np.float32)
            cam_cnr, lidar_cnr, _ = _cam_to_lidar_box(cam_box, ry)
            pts.append(_sample_box_points(rng, cam_box, ry))
            cars.append((cam_cnr, tz))
            img = Gnp.project_to_image_np(cam_cnr, P2)
            x1, y1 = img.min(1)
            x2, y2 = img.max(1)
            lines.append(
                "Car 0.00 0 {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} "
                "{:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f} {:.2f}".format(
                    -ry, max(x1, 0), max(y1, 0),
                    min(x2, image_hw[1] - 1), min(y2, image_hw[0] - 1),
                    h, w, l, tx, ty, tz, ry))
        scan = np.vstack(pts).astype(np.float32)
        scan.tofile(osp.join(obj, "velodyne", index + ".bin"))
        with open(osp.join(obj, "label_2", index + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(osp.join(obj, "calib", index + ".txt"), "w") as f:
            z12 = " ".join(["0"] * 12)
            f.write("P0: " + z12 + "\n")
            f.write("P1: " + z12 + "\n")
            f.write("P2: " + " ".join(str(v) for v in P2.reshape(-1)) + "\n")
            f.write("P3: " + " ".join(str(v) for v in P2.reshape(-1)) + "\n")
            f.write("R0_rect: " + " ".join(str(v) for v in R0.reshape(-1))
                    + "\n")
            f.write("Tr_velo_to_cam: "
                    + " ".join(str(v) for v in TR_VELO2CAM.reshape(-1)) + "\n")
            f.write("Tr_imu_to_velo: " + z12 + "\n")
        _write_png(osp.join(obj, "image_2", index + ".png"),
                   _draw_cars(rng, image_hw, cars))
        if write_bv:
            np.save(osp.join(obj, "lidar_bv", index + ".npy"),
                    point_cloud_2_top_host(scan))

    half = min(max(1, int(round(num_frames * train_frac))),
               max(1, num_frames - 1))
    split_frames = {"train": indices[:half], "val": indices[half:],
                    "trainval": indices, "test": indices}
    for s in splits:
        with open(osp.join(root, "ImageSets", s + ".txt"), "w") as f:
            f.write("\n".join(split_frames.get(s, indices)) + "\n")
    return root


def generate_voc(root, num_images=4, objects_per_image=3, seed=0,
                 image_hw=(375, 500), year="2007"):
    """A PASCAL VOC tree for the legacy 2D path (data/pascal_voc.py):
    <root>/VOC<year>/{JPEGImages,Annotations,ImageSets/Main} with
    num_images noise JPEGs, each with objects_per_image filled rectangles of
    random VOC classes (1-based pixel corners in the XML, the last object of
    every other image marked difficult), and the splits trainval and test
    (every image) and train and val (the halves). Draws come from
    np.random.RandomState(seed). Returns root."""
    from PIL import Image, ImageDraw

    from mv3d_tf_tpu_torch.data.pascal_voc import VOC_CLASSES

    rng = np.random.RandomState(seed)
    d = osp.join(root, "VOC" + year)
    for sub in ("JPEGImages", "Annotations", osp.join("ImageSets", "Main")):
        os.makedirs(osp.join(d, sub), exist_ok=True)
    h, w = image_hw
    ids = ["{:06d}".format(i + 1) for i in range(num_images)]
    for n, idx in enumerate(ids):
        im = Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8))
        draw = ImageDraw.Draw(im)
        objs = []
        for k in range(objects_per_image):
            bw, bh = rng.randint(w // 6, w // 2), rng.randint(h // 6, h // 2)
            x1, y1 = rng.randint(1, w - bw), rng.randint(1, h - bh)
            cls = VOC_CLASSES[rng.randint(1, len(VOC_CLASSES))]
            draw.rectangle([x1 - 1, y1 - 1, x1 + bw - 2, y1 + bh - 2],
                           fill=tuple(int(c) for c in rng.randint(0, 256, 3)))
            difficult = int(k == objects_per_image - 1 and n % 2 == 1)
            objs.append("<object><name>{}</name><difficult>{}</difficult>"
                        "<bndbox><xmin>{}</xmin><ymin>{}</ymin><xmax>{}"
                        "</xmax><ymax>{}</ymax></bndbox></object>".format(
                            cls, difficult, x1, y1, x1 + bw - 1, y1 + bh - 1))
        im.save(osp.join(d, "JPEGImages", idx + ".jpg"), quality=95)
        with open(osp.join(d, "Annotations", idx + ".xml"), "w") as f:
            f.write("<annotation>{}</annotation>\n".format("".join(objs)))
    half = max(1, num_images // 2)
    for split, members in (("trainval", ids), ("test", ids),
                           ("train", ids[:half]), ("val", ids[half:])):
        with open(osp.join(d, "ImageSets", "Main", split + ".txt"), "w") as f:
            f.write("\n".join(members) + "\n")
    return root
