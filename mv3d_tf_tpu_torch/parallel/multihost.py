"""Multi-host evaluation: frames split per host (mv3d_tf_tpu/parallel/
multihost.py, the same names and shard payload).

The evaluation loop is frame-parallel, so hosts need no collectives: each
evaluates a contiguous frame shard, writes a shard pickle, and one merge
pass puts the shards into the single-process detections pickles, byte for
byte (slots carry global frame indices; nothing is reordered or rescored).

    host i:  python -m mv3d_tf_tpu_torch.tools.test_net ... \\
                 --host_id i --host_count N
    merge:   python -m mv3d_tf_tpu_torch.tools.test_net ... \\
                 --host_count N --merge_shards

The merge also runs the imdb's evaluation on the merged detections, so the
AP comes out once, over the whole split.
"""

import os
import pickle

import numpy as np


def shard_indices(num_items, host_id, host_count):
    """Contiguous per-host frame ranges, balanced to within one frame."""
    assert 0 <= host_id < host_count, (host_id, host_count)
    base, extra = divmod(num_items, host_count)
    start = host_id * base + min(host_id, extra)
    size = base + (1 if host_id < extra else 0)
    return list(range(start, start + size))


def shard_path(output_dir, host_id, host_count):
    return os.path.join(output_dir, "detections_shard_{}_of_{}.pkl".format(
        host_id, host_count))


def run_host_shard(params, imdb, host_id, host_count,
                   weights_filename="default", **test_kwargs):
    """Evaluate this host's frame shard (solver.test_net over its frames,
    test_kwargs passed on) and write the shard pickle; returns its path."""
    from mv3d_tf_tpu_torch.config import get_output_dir
    from mv3d_tf_tpu_torch.solver import test_net

    indices = shard_indices(imdb.num_images, host_id, host_count)
    all_boxes, all_cnr = test_net(
        params, imdb, weights_filename=weights_filename,
        frame_indices=indices, evaluate=False, **test_kwargs)
    output_dir = get_output_dir(imdb, weights_filename)
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "host_id": host_id, "host_count": host_count, "indices": indices,
        "boxes": [[all_boxes[c][i] for i in indices]
                  for c in range(imdb.num_classes)],
        "boxes_cnr": [[all_cnr[c][i] for i in indices]
                      for c in range(imdb.num_classes)],
    }
    path = shard_path(output_dir, host_id, host_count)
    with open(path, "wb") as f:
        pickle.dump(payload, f, pickle.HIGHEST_PROTOCOL)
    return path


def _norm(v):
    """v rebuilt with the canonical float32 dtype instance. Unpickled arrays
    carry fresh dtype objects, which defeat the pickler's memo and give an
    equal array another byte stream (np.array(v, np.float32) would keep v's
    dtype object)."""
    if not len(v):
        return v
    out = np.empty(np.shape(v), np.dtype(np.float32))
    out[...] = v
    return out


def merge_shards(imdb, host_count, weights_filename="default",
                 evaluate=True, log=print):
    """Merge the shard pickles into detections.pkl and detections_cnr.pkl,
    and evaluate them with evaluate. Returns (all_boxes, all_boxes_cnr); the
    pickles are byte-identical to a single-process solver.test_net's."""
    from mv3d_tf_tpu_torch.config import get_output_dir

    output_dir = get_output_dir(imdb, weights_filename)
    k, n = imdb.num_classes, imdb.num_images
    all_boxes = [[[] for _ in range(n)] for _ in range(k)]
    all_cnr = [[[] for _ in range(n)] for _ in range(k)]
    seen = np.zeros(n, bool)
    for h in range(host_count):
        path = shard_path(output_dir, h, host_count)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert payload["host_count"] == host_count, path
        for c in range(k):
            for j, i in enumerate(payload["indices"]):
                all_boxes[c][i] = _norm(payload["boxes"][c][j])
                all_cnr[c][i] = _norm(payload["boxes_cnr"][c][j])
        seen[payload["indices"]] = True
    assert seen.all(), "missing frames after merge: {}".format(
        np.where(~seen)[0][:10])

    for name, boxes in (("detections.pkl", all_boxes),
                        ("detections_cnr.pkl", all_cnr)):
        with open(os.path.join(output_dir, name), "wb") as f:
            pickle.dump(boxes, f, pickle.HIGHEST_PROTOCOL)
    if evaluate:
        log("Evaluating merged detections ({} hosts)".format(host_count))
        imdb.evaluate_detections(all_boxes, all_cnr, output_dir)
    return all_boxes, all_cnr
