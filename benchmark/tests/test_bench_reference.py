"""The reference against the port, at small shapes on the CPU and in
float32: the same detections where both compute in full precision, the
same raster and the same pooled maps bit for bit. (The test imports both;
the reference itself imports neither the port nor JAX.)"""

import numpy as np
import torch

from benchmark.drivers.mv3d_common import crop_raster
from benchmark.lib import weights as W
from benchmark.reference import frcnn, mv3d, nets
from benchmark.reference import ops as ref_ops
from benchmark.tests import small
from benchmark.traffic import generate

SEED = 2**31 + 101


def _mv3d_frame():
    _, _, cfg, traffic, *_ = small.cell_files("mv3d.online_b1")
    pool = generate.make(traffic, SEED)
    raster = crop_raster(ref_ops.point_cloud_2_top_np(pool["scans"][0]),
                         cfg["bev_hw"])
    h, w = cfg["image_hw"]
    image = np.ascontiguousarray(pool["images"][0][:h, :w])
    return cfg, pool, raster, image


def test_raster_is_the_ports_bit_for_bit():
    from mv3d_tf_tpu_torch.ops import bev
    _, pool, _, _ = _mv3d_frame()
    for scan in pool["scans"]:
        pts, valid = bev.pad_points(scan, 32768)
        got = bev.point_cloud_2_top_batch(pts[None], valid[None],
                                          device="cpu")[0].numpy()
        np.testing.assert_array_equal(got,
                                      ref_ops.point_cloud_2_top_np(scan))


def test_roi_pool_is_the_ports_bit_for_bit():
    from mv3d_tf_tpu_torch.ops import roi_pool as port
    g = torch.Generator().manual_seed(SEED)
    feat = torch.randn(12, 20, 8, generator=g)
    rois = port.boundary_rois(12 * 8, 20 * 8)
    rois[:, 0] = 0
    np.testing.assert_array_equal(ref_ops.roi_pool(feat, rois).numpy(),
                                  port.roi_pool(feat, rois).numpy())


def test_mv3d_detector_matches_the_port_in_float32():
    from mv3d_tf_tpu_torch import eval as E
    cfg, pool, raster, image = _mv3d_frame()
    t = cfg["test"]
    weights = W.make(cfg, SEED, "cpu")
    params = W.module_dict(weights)
    detect = E.build_detect_fn(cfg["bev_hw"][0] // 8, cfg["bev_hw"][1] // 8,
                               t["pre_nms_top_n"], t["post_nms_top_n"],
                               t["rpn_nms_thresh"])
    got = {k: v.numpy() for k, v in
           detect(params, raster, image, pool["calib"]).items()}
    bev, img = torch.from_numpy(raster), torch.from_numpy(image)
    calib = torch.from_numpy(pool["calib"])
    want = mv3d.detect(weights, bev, img, calib, t)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("rois_3d", "scores", "boxes_cnr", "boxes_cnr_r", "boxes_bv"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4)
    dets = E.frame_detections(got, cfg["num_classes"], t["score_thresh"],
                              t["nms"], t["max_per_image"])
    r = mv3d.judge_frame(weights, got, dets, bev, img, calib, cfg)
    assert r["nms_gap"] == 0 and r["missing_rois"] == 0
    assert r["roi_err"] < 1e-4 and r["logit_err"] < 1e-3
    assert r["offset_err"] < 1e-3 and r["box_err"] == 0
    assert r["dets_mismatch"] == 0 and r["nms_overlap"] < t["rpn_nms_thresh"]


def test_frcnn_detector_matches_the_port_in_float32():
    from mv3d_tf_tpu_torch import faster_rcnn_2d as F2
    from benchmark.drivers.detect_2d import class_detections
    _, _, cfg, traffic, *_ = small.cell_files("faster_rcnn.detect_b1")
    t = cfg["test"]
    pool = generate.make(traffic, SEED, pixel_means=cfg["pixel_means"])
    weights = W.make(cfg, SEED, "cpu")
    params = W.module_dict(weights)
    h, w = cfg["image_hw"]
    detect = F2.build_im_detect_2d(h // 16, w // 16, t["pre_nms_top_n"],
                                   t["post_nms_top_n"])
    image, im_info = pool["images"][0], pool["im_info"]
    got = {k: v.numpy() for k, v in detect(params, image, im_info).items()}
    want = frcnn.im_detect(weights, torch.from_numpy(image),
                           torch.from_numpy(im_info), t)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("rois", "scores", "boxes"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-2)
    dets = class_detections(got, im_info[2], t["score_thresh"], t["nms"],
                            t["max_per_image"])
    r = frcnn.judge_image(weights, got, dets, torch.from_numpy(image),
                          torch.from_numpy(im_info), cfg)
    assert r["nms_gap"] == 0 and r["missing_rois"] == 0
    assert r["score_err"] < 1e-4 and r["box_err_px"] < 1e-2
    assert r["dets_mismatch"] == 0


def test_fp8_rounds_to_e4m3_under_one_scale():
    x = torch.tensor([448.0, 1.0, -3.3, 0.0])
    y = nets.fp8(x)
    assert y[0] == 448.0 and y[3] == 0.0 and y[2] == -3.25
