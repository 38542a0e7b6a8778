"""Host I/O of the BEV front end, the counterpart of
mv3d_tf_tpu/utils/native.py:66-117 and 262-277, in numpy only.

The JAX package binds a C++ loader and rasterizer (native/mv3d_loader.cc,
native/bev_raster.cc) through ctypes and falls back to numpy without a
toolchain. This module is numpy only: it keeps the same output shapes,
dtypes and trim/pad rule, and reads a batch's files on a thread pool
(np.fromfile releases the interpreter lock). The C++ host code is not
ported yet (ROADMAP.md, Queue 1 item 5).
"""

import concurrent.futures

import numpy as np

from mv3d_tf_tpu_torch.ops.bev import point_cloud_2_top_np


def _read_scan(path, out, valid):
    """One .bin into its (bucket, 4) row: the first min(N, bucket) points,
    zeros after; a trailing partial record is dropped, as the C++ loader
    drops it (mv3d_loader.cc:31). A missing file raises OSError."""
    raw = np.fromfile(path, dtype=np.float32)
    n = min(raw.size // 4, out.shape[0])
    out[:n] = raw[:n * 4].reshape(n, 4)
    valid[:n] = True


def load_velodyne_padded(path, bucket=131072):
    """One scan -> ((bucket, 4) float32, (bucket,) bool)."""
    out = np.zeros((bucket, 4), np.float32)
    valid = np.zeros((bucket,), bool)
    _read_scan(path, out, valid)
    return out, valid


def load_velodyne_batch(paths, bucket=131072, n_threads=8):
    """Many scans -> ((n, bucket, 4) float32, (n, bucket) bool), read on
    up to n_threads threads."""
    n = len(paths)
    out = np.zeros((n, bucket, 4), np.float32)
    valid = np.zeros((n, bucket), bool)
    if n:
        with concurrent.futures.ThreadPoolExecutor(
                max(1, min(n_threads, n))) as pool:
            for f in [pool.submit(_read_scan, p, out[i], valid[i])
                      for i, p in enumerate(paths)]:
                f.result()
    return out, valid


def point_cloud_2_top_host(points):
    """(N, 4) points -> (601, 601, 9) float32 raster on the host: the
    port's numpy twin (ops/bev.py:point_cloud_2_top_np)."""
    return point_cloud_2_top_np(points)
