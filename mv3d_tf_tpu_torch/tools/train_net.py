"""Train an MV3D network: the counterpart of tools/train_net.py, with the
same flags.

    python -m mv3d_tf_tpu_torch.tools.train_net --imdb kitti_train \\
        --kitti_path <kitti> [--iters 70000] [--weights vgg16.npy] \\
        [--dtype bfloat16|float32] [--resume] [--rand] [--device cuda|cpu] \\
        [--set TRAIN.SNAPSHOT_ITERS 5000 ...]

Runs solver.train_net on the card (``--device cpu`` for the plain versions
on the CPU): snapshots ``<prefix>_iter_<N>.pt`` with the Adam and LR
scheduler state under output/<EXP_DIR>/<imdb>/, and ``--resume`` continues
from the latest of them. Without ``--rand`` numpy and the torch generator
are seeded from cfg.RNG_SEED.

``--network VGGnet_train`` (or any ``VGGnet*``) trains the legacy 2D
network through solver.train_net_2d (momentum SGD, conv1/conv2 frozen) over
``--imdb voc_<year>_<split> --devkit_path <VOCdevkit>``, ``kitti2d_<split>
--kitti_path <kitti>`` or another 2D dataset of data/kitti.get_imdb: end
to end with ``TRAIN.HAS_RPN True`` (the end2end cfg), and with it off (the
default) Fast R-CNN over the precomputed proposals of the imdb's roidb
(solver.train_net_fast_rcnn; experiments/cfgs/kitti_rcnn.yml adds the image
pyramid). For that branch each entry gets max_classes and max_overlaps
from its gt_overlaps, as the reference's roi_data_layer/roidb.py
prepare_roidb gives them (the JAX tool does not, so its run stops at
multiscale.add_bbox_regression_targets' "call prepare_roidb first"). The
2D loops do not resume.
"""

import argparse
import pprint
import sys


def build_parser():
    parser = argparse.ArgumentParser(description="Train an MV3D network")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--device_id", dest="device_id", default=0, type=int)
    parser.add_argument("--solver", dest="solver", default=None, type=str)
    parser.add_argument("--iters", dest="max_iters", default=70000, type=int)
    parser.add_argument("--weights", dest="pretrained_model", default=None,
                        type=str)
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("--imdb", dest="imdb_name", default="kitti_train",
                        type=str)
    parser.add_argument("--rand", dest="randomize", action="store_true",
                        help="randomize (do not use a fixed seed)")
    parser.add_argument("--network", dest="network_name",
                        default="MV3D_train", type=str)
    parser.add_argument("--kitti_path", dest="kitti_path", default=None,
                        type=str)
    parser.add_argument("--devkit_path", dest="devkit_path", default=None,
                        type=str, help="VOCdevkit path for voc_* imdbs")
    parser.add_argument("--resume", dest="resume", action="store_true",
                        help="resume from the latest snapshot (with the "
                             "Adam and LR scheduler state)")
    parser.add_argument("--dtype", dest="dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--set", dest="set_cfgs", default=None,
                        nargs=argparse.REMAINDER)
    return parser


def main(argv=None):
    parser = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    args = parser.parse_args(argv)
    print("Called with args:")
    print(args)
    from mv3d_tf_tpu_torch.models.factory import get_network
    try:
        is_2d = get_network(args.network_name).is_2d
    except KeyError as e:
        raise SystemExit(e.args[0])
    if is_2d and args.resume:
        raise SystemExit("--resume: the 2D training loop does not resume "
                         "(solver.train_net_2d, as in the JAX package)")

    import numpy as np
    import torch

    from mv3d_tf_tpu_torch.config import (cfg, cfg_from_file, cfg_from_list,
                                          get_output_dir)
    from mv3d_tf_tpu_torch.data.kitti import get_imdb, prepare_roidb
    from mv3d_tf_tpu_torch.solver import train_net, train_net_2d

    if args.cfg_file is not None:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs)
    print("Using config:")
    pprint.pprint(cfg)

    if not args.randomize:
        np.random.seed(cfg.RNG_SEED)
    imdb = get_imdb(args.imdb_name, kitti_path=args.kitti_path,
                    devkit_path=args.devkit_path)
    print("Loaded dataset `{:s}` for training".format(imdb.name))
    if is_2d:
        roidb = imdb.roidb
        for i, entry in enumerate(roidb):
            entry.setdefault("image_path", imdb.image_path_at(i))
            if not cfg.TRAIN.HAS_RPN and "max_classes" not in entry:
                overlaps = entry["gt_overlaps"]
                entry["max_classes"] = overlaps.argmax(axis=1)
                entry["max_overlaps"] = overlaps.max(axis=1)
    else:
        roidb = prepare_roidb(imdb)
    print("{:d} roidb entries".format(len(roidb)))
    output_dir = get_output_dir(imdb, None)
    print("Output will be saved to `{:s}`".format(output_dir))
    print("Use network `{:s}` in training".format(args.network_name))

    device = (torch.device("cuda", args.device_id) if args.device == "cuda"
              else torch.device("cpu"))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    seed = int(np.random.rand() * 1e6) if args.randomize else None
    if is_2d:
        return train_net_2d(imdb, roidb, output_dir,
                            pretrained_model=args.pretrained_model,
                            max_iters=args.max_iters, compute_dtype=dtype,
                            seed=seed, device=device)
    return train_net(imdb, roidb, output_dir,
                     pretrained_model=args.pretrained_model,
                     max_iters=args.max_iters, compute_dtype=dtype,
                     seed=seed, resume=args.resume, device=device)


if __name__ == "__main__":
    main()
