"""KITTI-raw tracklet XML -> per-frame gt 3D corner labels (.npy); the
counterpart of tools/tracklet2label.py, with the same flags.

    python -m mv3d_tf_tpu_torch.tools.tracklet2label \\
        --xml <drive>/tracklet_labels.xml --out <seq>/gt_boxes3d [--type Car]

Parses the tracklet_labels.xml format with xml.etree (the reference's
tools/tracklet2label.py needs an external pykitti/didi parser, :13-14).
Each output file <frame:010d>.npy holds (N, 24) lidar-frame corner boxes
(x0..x7, y0..y7, z0..z7), as obj_to_gt_boxes3d writes them (:71-88); the
imdb data/kitti_raw.KittiRaw reads them.
"""

import argparse
import os
import os.path as osp
import xml.etree.ElementTree as ET

import numpy as np


def parse_tracklets(xml_path):
    """tracklet_labels.xml -> a list of dicts with per-frame poses."""
    root = ET.parse(xml_path).getroot()
    tracklets = []
    for item in root.find("tracklets").findall("item"):
        t = {
            "objectType": item.findtext("objectType"),
            "h": float(item.findtext("h")),
            "w": float(item.findtext("w")),
            "l": float(item.findtext("l")),
            "first_frame": int(item.findtext("first_frame")),
            "poses": [],
        }
        for pose in item.find("poses").findall("item"):
            t["poses"].append({key: float(pose.findtext(key))
                               for key in ("tx", "ty", "tz", "rz")})
        tracklets.append(t)
    return tracklets


def box_to_corners(tx, ty, tz, l, w, h, rz):
    """The lidar-frame, yaw-rotated 24-corner box (tracklet poses are in the
    velodyne frame with the box origin at the bottom center)."""
    x_c = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (l / 2.0)
    y_c = np.array([1, -1, -1, 1, 1, -1, -1, 1]) * (w / 2.0)
    z_c = np.array([0, 0, 0, 0, 1, 1, 1, 1]) * h
    c, s = np.cos(rz), np.sin(rz)
    xr = c * x_c - s * y_c + tx
    yr = s * x_c + c * y_c + ty
    zr = z_c + tz
    return np.concatenate([xr, yr, zr]).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description="tracklet XML -> gt corner npy")
    p.add_argument("--xml", required=True, help="tracklet_labels.xml")
    p.add_argument("--out", required=True, help="output dir for <frame>.npy")
    p.add_argument("--type", default="Car",
                   help="object type filter (Car default)")
    args = p.parse_args(argv)

    frames = {}
    for t in parse_tracklets(args.xml):
        if args.type and t["objectType"] != args.type:
            continue
        for k, pose in enumerate(t["poses"]):
            frames.setdefault(t["first_frame"] + k, []).append(
                box_to_corners(pose["tx"], pose["ty"], pose["tz"],
                               t["l"], t["w"], t["h"], pose["rz"]))
    os.makedirs(args.out, exist_ok=True)
    for fr, boxes in sorted(frames.items()):
        np.save(osp.join(args.out, str(fr).zfill(10) + ".npy"),
                np.stack(boxes))
    print("wrote {} frames ({} boxes) to {}".format(
        len(frames), sum(len(b) for b in frames.values()), args.out))
    return frames


if __name__ == "__main__":
    main()
