"""Snapshots of the port's training state (mv3d_tf_tpu/utils/checkpoint.py).

The JAX package writes orbax directories; the port writes one
``torch.save`` file, named by the reference's scheme
``<SNAPSHOT_PREFIX>[_<INFIX>]_iter_<N>`` with a ``.pt`` suffix, that holds
the parameters and, from the training loop, the Adam state and the LR
scheduler's state (the reference restarts Adam on every run).
``load_pretrained`` reads a reference-style ``.npy`` weight dict
(utils/weights.load_npy_weights) or a snapshot the port wrote; an orbax
directory raises.
"""

import os
import os.path as osp

import torch

from mv3d_tf_tpu_torch.config import cfg

SUFFIX = ".pt"


def snapshot_name(iter_n, prefix=None, infix=None):
    prefix = cfg.TRAIN.SNAPSHOT_PREFIX if prefix is None else prefix
    infix = cfg.TRAIN.SNAPSHOT_INFIX if infix is None else infix
    mid = ("_" + infix) if infix else ""
    return "{}{}_iter_{:d}".format(prefix, mid, iter_n)


def snapshot_iter(path):
    """The iteration of a snapshot path: ``..._iter_<N>.pt`` -> N."""
    name = osp.basename(path)
    if name.endswith(SUFFIX):
        name = name[:-len(SUFFIX)]
    return int(name.rsplit("_iter_", 1)[1])


def save_checkpoint(output_dir, iter_n, params, opt=None, sched=None):
    """Write the parameters, and the optimizer's and the LR scheduler's
    state when given, to <output_dir>/<snapshot_name>.pt."""
    os.makedirs(output_dir, exist_ok=True)
    path = osp.abspath(osp.join(output_dir, snapshot_name(iter_n) + SUFFIX))
    blob = {"params": params.state_dict()}
    if opt is not None:
        blob["opt"] = opt.state_dict()
    if sched is not None:
        blob["sched"] = sched.state_dict()
    torch.save(blob, path)
    print("Wrote snapshot to: {:s}".format(path))
    return path


def load_checkpoint(path, params, opt=None, sched=None):
    """Load a snapshot of save_checkpoint into ``params`` in place, onto the
    devices its tensors are on, and into ``opt`` and ``sched`` when given;
    returns params. A params-only load of a full snapshot works. A snapshot
    without scheduler state (a constant-lr run) leaves ``sched`` where it
    was built and gives the optimizer the scheduler's lr. A snapshot with
    scheduler state (a decayed run) loaded with ``opt`` but no ``sched``
    raises ValueError, as the JAX package refuses it (solver.py:142-144):
    the optimizer would go on at the decayed lr."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if opt is not None and sched is None and "sched" in blob:
        raise ValueError(
            "{} was written with cfg.TRAIN.LR_DECAY on (it holds LR "
            "scheduler state); resuming it with cfg.TRAIN.LR_DECAY off "
            "would go on at its decayed lr. Resume with "
            "cfg.TRAIN.LR_DECAY on".format(path))
    params.load_state_dict(blob["params"])
    if opt is not None:
        if "opt" not in blob:
            raise KeyError("{} holds no optimizer state".format(path))
        opt.load_state_dict(blob["opt"])
    if sched is not None:
        if "sched" in blob:
            sched.load_state_dict(blob["sched"])
        for group, lr in zip(sched.optimizer.param_groups,
                             sched.get_last_lr()):
            group["lr"] = lr
    return params


def latest_snapshot(output_dir):
    """The highest-iteration snapshot file in output_dir, or None."""
    if not osp.isdir(output_dir):
        return None
    best, best_iter = None, -1
    for name in os.listdir(output_dir):
        if "_iter_" in name and name.endswith(SUFFIX):
            try:
                it = snapshot_iter(name)
            except ValueError:
                continue
            if it > best_iter:
                best, best_iter = osp.join(output_dir, name), it
    return best


def load_pretrained(params, path):
    """Load a reference-style .npy weight dict or a port snapshot into
    ``params`` in place; returns params."""
    from mv3d_tf_tpu_torch.utils.weights import load_npy_weights
    if path.endswith(".npy"):
        return load_npy_weights(params, path, ignore_missing=True)
    if osp.isdir(path):
        raise ValueError(
            "{} is a directory: an orbax snapshot of the JAX package. The "
            "port reads .npy weight dicts and its own torch.save snapshots "
            "(.pt); it does not read orbax".format(path))
    return load_checkpoint(path, params)
