"""Evaluate the MV3D detector over a KITTI split: the counterpart of
tools/test_net.py, with the same flags.

    python -m mv3d_tf_tpu_torch.tools.test_net --imdb kitti_val \\
        --kitti_path <kitti> [--weights w.npy] [--dtype bfloat16|float32] \\
        [--int8 [--int8_stem s2d_int8] [--int8_head]] [--device cuda|cpu] \\
        [--set TEST.RPN_POST_NMS_TOP_N 300 ...]

Runs solver.test_net: batched detection on the card (``--device cpu`` for
the plain versions on the CPU), the detections pickles under
output/<EXP_DIR>/<imdb>/<weights>/, the KITTI result files and the AP
tables. ``--weights`` takes a reference-style .npy weight dict or a
snapshot the port wrote; without it the port's own random init
(``mv3d.init_params`` from a torch generator seeded 0) stands in.
``--host_id i --host_count N`` evaluates host i's contiguous frame shard
and writes its shard pickle; ``--host_count N --merge_shards`` merges the N
shards into the detections pickles (byte for byte a single run's) and
evaluates them (parallel/multihost.py). The VGGnet* networks ignore these
flags, as the JAX tool does.

``--network VGGnet_test`` (or any ``VGGnet*``) runs the legacy 2D Faster
R-CNN through solver.test_net_2d instead, over ``--imdb voc_<year>_<split>
--devkit_path <VOCdevkit>`` or ``kitti2d_<split> --kitti_path <kitti>``:
the detections pickle and the VOC AP (or the KITTI 2D AP table), with
``vggnet.init_params_2d`` seeded 0 standing in for missing weights.
"""

import argparse
import os
import pprint
import sys
import time


def build_parser():
    parser = argparse.ArgumentParser(description="Test an MV3D network")
    parser.add_argument("--device", dest="device", default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--device_id", dest="device_id", default=0, type=int)
    parser.add_argument("--def", dest="prototxt", default=None, type=str)
    parser.add_argument("--weights", dest="model", default=None, type=str,
                        help="snapshot path (.npy dict or the port's .pt)")
    parser.add_argument("--cfg", dest="cfg_file", default=None, type=str)
    parser.add_argument("--wait", dest="wait", default=True, type=bool,
                        help="wait until the snapshot exists")
    parser.add_argument("--imdb", dest="imdb_name", default="kitti_val",
                        type=str)
    parser.add_argument("--comp", dest="comp_mode", action="store_true")
    parser.add_argument("--network", dest="network_name",
                        default="MV3D_test", type=str)
    parser.add_argument("--kitti_path", dest="kitti_path", default=None,
                        type=str)
    parser.add_argument("--devkit_path", dest="devkit_path", default=None,
                        type=str, help="VOCdevkit path for voc_* imdbs")
    parser.add_argument("--dtype", dest="dtype", default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--host_id", dest="host_id", default=None, type=int,
                        help="evaluate only this host's frame shard "
                             "(MV3D networks; VGGnet* ignores it)")
    parser.add_argument("--host_count", dest="host_count", default=1,
                        type=int, help="total hosts sharding the eval")
    parser.add_argument("--merge_shards", dest="merge_shards",
                        action="store_true",
                        help="merge per-host shard pickles and evaluate "
                             "(MV3D networks; VGGnet* ignores it)")
    parser.add_argument("--int8", dest="int8", action="store_true",
                        help="int8 PTQ eval (calibrates on the first "
                             "frames; tools/quant_check is the accuracy "
                             "gate)")
    parser.add_argument("--int8_stem", dest="int8_stem", default=None,
                        choices=[None, "bf16", "s2d", "s2d_int8"])
    parser.add_argument("--int8_conv_impl", dest="int8_conv_impl",
                        default="xla", choices=["xla", "pallas", "dots"])
    parser.add_argument("--int8_head", dest="int8_head",
                        action="store_true")
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
    import torch

    from mv3d_tf_tpu_torch.models.factory import get_network
    try:
        is_2d = get_network(args.network_name).is_2d
    except KeyError as e:
        raise SystemExit(e.args[0])

    from mv3d_tf_tpu_torch.config import cfg, cfg_from_file, cfg_from_list
    from mv3d_tf_tpu_torch.data.kitti import get_imdb
    from mv3d_tf_tpu_torch.models import mv3d, vggnet
    from mv3d_tf_tpu_torch.solver import test_net, test_net_2d
    from mv3d_tf_tpu_torch.utils.checkpoint import load_pretrained

    if args.cfg_file is not None:
        cfg_from_file(args.cfg_file)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs)
    print("Using config:")
    pprint.pprint(cfg)

    # wait for the training side to produce the snapshot (test_net.py:70-72)
    while args.model and not os.path.exists(args.model) and args.wait:
        print("Waiting for {} to exist...".format(args.model))
        time.sleep(10)

    imdb = get_imdb(args.imdb_name, kitti_path=args.kitti_path,
                    devkit_path=args.devkit_path)
    print("Use network `{:s}` in testing".format(args.network_name))

    weights_filename = "default"
    if args.model:
        weights_filename = os.path.splitext(os.path.basename(args.model))[0]
    if args.merge_shards and not is_2d:     # reads pickles, needs no params
        from mv3d_tf_tpu_torch.parallel.multihost import merge_shards
        return merge_shards(imdb, args.host_count,
                            weights_filename=weights_filename)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = (vggnet.init_params_2d(gen, n_classes=imdb.num_classes,
                                    device=device) if is_2d
              else mv3d.init_params(gen, device=device))
    if args.model:
        load_pretrained(params, args.model)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else None
    if is_2d:
        return test_net_2d(params, imdb, weights_filename=weights_filename,
                           compute_dtype=dtype)
    if args.host_id is not None:
        from mv3d_tf_tpu_torch.parallel.multihost import run_host_shard
        path = run_host_shard(params, imdb, args.host_id, args.host_count,
                              weights_filename=weights_filename,
                              compute_dtype=dtype)
        print("wrote shard " + path)
        return path
    quant_cfg = None
    if args.int8:
        quant_cfg = {"stem": args.int8_stem,
                     "conv_impl": args.int8_conv_impl,
                     "int8_head": args.int8_head}
    return test_net(params, imdb, weights_filename=weights_filename,
                    compute_dtype=dtype, quant_cfg=quant_cfg)


if __name__ == "__main__":
    main()
