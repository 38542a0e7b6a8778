"""Small shapes of the benchmark's cells, for runs on the CPU: the cells'
own files with the inputs, the fc widths and the proposal budgets cut."""

import copy

from benchmark.lib import harness as H

MV3D = {"bev_hw": [64, 64], "image_hw": [64, 128], "fc_dim": 64}
FRCNN = {"image_hw": [96, 160], "fc_dim": 64}
BUDGET = {"pre_nms_top_n": 200, "post_nms_top_n": 20, "max_per_image": 20}


def cell_files(name):
    """load_cell(name) at small shapes."""
    cell, work, cfg, traffic, e2e, per_layer, units = H.load_cell(name)
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(MV3D if cfg["network"] == "mv3d" else FRCNN)
    cfg["test"].update(BUDGET)
    traffic["pool"] = 2 * traffic["batch"] if traffic["batch"] > 1 else 2
    traffic["batch"] = min(traffic["batch"], 2)
    traffic["pool"] = 2 * traffic["batch"]
    if traffic["kind"] == "lidar_frames":
        traffic["points"] = 20000
        traffic["car_range_m"] = [3.0, 6.0]
    else:
        traffic.update({"image_hw": [60, 100], "scale": 90, "max_size": 150,
                        "bucket_hw": [96, 160]})
    return cell, work, cfg, traffic, e2e, per_layer, units
