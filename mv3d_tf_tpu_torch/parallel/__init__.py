"""Multi-device and multi-host scaling on torch.distributed
(mv3d_tf_tpu/parallel/): the data-parallel train step, frame- and
row-sharded detection (mesh.py), per-host evaluation shards (multihost.py)
and the multi-device dry run (dryrun.py)."""
