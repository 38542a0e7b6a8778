"""The port's host code in C++ (native/*.cc) through ctypes, the counterpart
of mv3d_tf_tpu/utils/native.py, with the same public names:

  * the velodyne loader (native/mv3d_loader.cc): ``load_velodyne_padded``,
    ``load_velodyne_batch`` (threaded);
  * the host BEV raster (native/bev_raster.cc): ``point_cloud_2_top_host``,
    ``bev_raster_files`` (threaded reads and rasters);
  * the KITTI AP matcher (native/kitti_eval.cc): ``eval_ap_native``, which
    data/kitti_eval.evaluate_ap_difficulty routes to;
  * the greedy NMS of the 2D detector's per-class step (native/nms_host.cc):
    ``nms_np_native``, ops/nms.nms_np's keep list bit for bit.

g++ builds each source at its first use into ``mv3d_tf_tpu_torch/_build/``,
under a name derived from the source and the flags (an edited source is
rebuilt, an unchanged one reused), compiling to a temporary name and
renaming it into place, so processes that build at once each load a whole
library. A missing g++ or a failed build raises with the compiler's
output: no route falls back to numpy. The numpy versions stay importable
as the plain versions the tests hold the C++ to:
``load_velodyne_padded_np``, ``load_velodyne_batch_np``,
ops/bev.point_cloud_2_top_np and ops/nms.nms_np. The raster takes
ops/bev.py's float32 slice bounds; it does not recompute them, as the JAX
package's C++ does in float64.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import threading

import numpy as np

from mv3d_tf_tpu_torch.geometry import (BEV_C, BEV_H, BEV_W, HEIGHT_MIN,
                                        N_SLICES, RES, TOP_X_MAX, TOP_X_MIN,
                                        TOP_Y_MAX)
from mv3d_tf_tpu_torch.ops.bev import _SLICE_BOUNDS, _X_SHIFT, _Y_SHIFT

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
SOURCES = osp.join(_PKG, "native")
BUILD_DIR = osp.join(_PKG, "_build")
GXX = "g++"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_F = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_ubyte)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_GRID = ([ctypes.c_float] * 5 + [_F, _F] + [ctypes.c_int32] * 6)
# library -> {C function: (restype, argtypes)}
_SIGNATURES = {
    "mv3d_loader": {
        "load_velodyne_batch": (None, [
            ctypes.c_char_p, ctypes.c_long, _F, _U8, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long]),
    },
    "kitti_eval": {
        "kitti_eval_ap": (None, [
            _F, _I64, _F, _F, _F, _I64, _I32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_float,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]),
    },
    "nms_host": {
        "nms_greedy_host": (ctypes.c_int64, [
            _F, _I64, ctypes.c_int64, ctypes.c_float, _I64]),
    },
    "bev_raster": {
        "bev_raster": (None, [_F, ctypes.c_int64] + _GRID + [_F]),
        "bev_raster_files": (None, [ctypes.c_char_p, ctypes.c_int64] + _GRID
                             + [_F, _I64, ctypes.c_int64]),
    },
}

_lock = threading.Lock()
_libs = {}


def gxx_path():
    path = shutil.which(GXX)
    if path is None:
        raise RuntimeError("g++ not found ({!r}): the port's host code in "
                           "{} cannot be built".format(GXX, SOURCES))
    return path


def build(name):
    """The path of lib<name>_<hash>.so, built from native/<name>.cc first
    if it is not there; raises with the compiler's output if g++ fails."""
    src = osp.join(SOURCES, name + ".cc")
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as fh:
        digest.update(fh.read())
    lib_path = osp.join(BUILD_DIR, "lib{}_{}.so".format(
        name, digest.hexdigest()[:16]))
    if osp.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.{}.tmp".format(lib_path, os.getpid(), threading.get_ident())
    cmd = [gxx_path(), *GXX_FLAGS, src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed (exit {}): {}\n{}{}".format(
                proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
        os.replace(tmp, lib_path)
    finally:
        if osp.exists(tmp):
            os.remove(tmp)
    return lib_path


def _load(name):
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build(name))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


def get_lib():
    """The velodyne loader's library, built first if needed."""
    return _load("mv3d_loader")


def get_eval_lib():
    """The AP matcher's library, built first if needed."""
    return _load("kitti_eval")


def get_bev_lib():
    """The host raster's library, built first if needed."""
    return _load("bev_raster")


def get_nms_lib():
    """The host NMS's library, built first if needed."""
    return _load("nms_host")


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _path_blob(paths):
    return b"".join(os.fsencode(p) + b"\0" for p in paths)


def _raise_unread(paths, counts):
    bad = [str(paths[i]) for i in np.flatnonzero(counts < 0)]
    if bad:
        raise IOError("failed to read: " + ", ".join(bad))


def load_velodyne_padded(path, bucket=131072):
    """One scan -> ((bucket, 4) float32, (bucket,) bool): the first
    min(N, bucket) points, zeros after; a trailing partial record is
    dropped. A missing or unreadable file raises IOError."""
    out, valid = load_velodyne_batch([path], bucket, n_threads=1)
    return out[0], valid[0]


def load_velodyne_batch(paths, bucket=131072, n_threads=8):
    """Many scans -> ((n, bucket, 4) float32, (n, bucket) bool), read on
    up to n_threads threads in C++. Raises IOError naming every file that
    could not be read."""
    n = len(paths)
    out = np.empty((n, bucket, 4), np.float32)
    valid = np.empty((n, bucket), bool)
    counts = np.zeros((n,), np.int64)
    get_lib().load_velodyne_batch(
        _path_blob(paths), n, _ptr(out, ctypes.c_float),
        _ptr(valid, ctypes.c_ubyte), int(bucket),
        _ptr(counts, ctypes.c_long), max(1, int(n_threads)))
    _raise_unread(paths, counts)
    return out, valid


def _read_scan(path, out, valid):
    """One .bin into its (bucket, 4) row, as the C++ loader reads it."""
    raw = np.fromfile(path, dtype=np.float32)
    n = min(raw.size // 4, out.shape[0])
    out[:n] = raw[:n * 4].reshape(n, 4)
    valid[:n] = True


def load_velodyne_padded_np(path, bucket=131072):
    """The numpy twin of load_velodyne_padded; a missing file raises
    OSError."""
    out = np.zeros((bucket, 4), np.float32)
    valid = np.zeros((bucket,), bool)
    _read_scan(path, out, valid)
    return out, valid


def load_velodyne_batch_np(paths, bucket=131072, n_threads=8):
    """The numpy twin of load_velodyne_batch, on a thread pool
    (np.fromfile releases the interpreter lock)."""
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


_LO = np.array([lo for lo, _ in _SLICE_BOUNDS], np.float32)
_HI = np.array([hi for _, hi in _SLICE_BOUNDS], np.float32)


def _grid_args():
    return (RES, TOP_X_MIN, TOP_X_MAX, TOP_Y_MAX, HEIGHT_MIN,
            _ptr(_LO, ctypes.c_float), _ptr(_HI, ctypes.c_float),
            BEV_H, BEV_W, BEV_C, N_SLICES, _X_SHIFT, _Y_SHIFT)


def point_cloud_2_top_host(points):
    """(N, 4) points -> (601, 601, 9) float32 raster on the host, in C++;
    bit for bit ops/bev.point_cloud_2_top_np."""
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError("point_cloud_2_top_host: points must be (N, 4), "
                         "got {}".format(pts.shape))
    out = np.zeros((BEV_H, BEV_W, BEV_C), np.float32)
    get_bev_lib().bev_raster(_ptr(pts, ctypes.c_float), len(pts),
                             *_grid_args(), _ptr(out, ctypes.c_float))
    return out


def bev_raster_files(paths, n_threads=8):
    """Read velodyne .bin files and rasterize each in C++ on up to
    n_threads threads: (n, 601, 601, 9) float32. Raises IOError naming
    every file that could not be read."""
    n = len(paths)
    out = np.zeros((n, BEV_H, BEV_W, BEV_C), np.float32)
    counts = np.zeros((n,), np.int64)
    get_bev_lib().bev_raster_files(
        _path_blob(paths), n, *_grid_args(), _ptr(out, ctypes.c_float),
        _ptr(counts, ctypes.c_int64), max(1, int(n_threads)))
    _raise_unread(paths, counts)
    return out


def _concat(frames, key, width):
    """One key of every frame as one contiguous float32 array, and the
    (n_frames + 1,) int64 offsets of each frame's rows."""
    parts = [np.asarray(fr[key], np.float32).reshape(-1, width)
             for fr in frames]
    off = np.zeros(len(frames) + 1, np.int64)
    off[1:] = np.cumsum([len(p) for p in parts])
    if not parts:
        return np.zeros((0,), np.float32), off
    return np.ascontiguousarray(np.concatenate(parts)).reshape(-1), off


def eval_ap_native(frames, iou_kind, iou_thresh, min_h, lvl_max):
    """kitti_eval_ap over frame dicts (the schema of
    data/kitti_eval.evaluate_ap_difficulty); iou_kind 0 is iou_2d, 1
    iou_3d_aabb. Returns (ap, npos)."""
    lib = get_eval_lib()
    dgeom = 6 if iou_kind == 1 else 4
    dets, det_off = _concat(frames, "dets", dgeom)
    scores, _ = _concat(frames, "scores", 1)
    det_h, _ = _concat(frames, "det_heights", 1)
    gts, gt_off = _concat(frames, "gts", dgeom)
    levels = np.ascontiguousarray(np.concatenate(
        [np.asarray(fr["levels"]).ravel() for fr in frames]
        + [np.zeros(0)]).astype(np.int32))
    out = np.zeros(2, np.float64)
    lib.kitti_eval_ap(
        _ptr(dets, ctypes.c_float), _ptr(det_off, ctypes.c_int64),
        _ptr(scores, ctypes.c_float), _ptr(det_h, ctypes.c_float),
        _ptr(gts, ctypes.c_float), _ptr(gt_off, ctypes.c_int64),
        _ptr(levels, ctypes.c_int32), len(frames), dgeom, int(iou_kind),
        float(iou_thresh), float(min_h), int(lvl_max),
        _ptr(out, ctypes.c_double))
    return float(out[0]), int(out[1])


def nms_np_native(dets, thresh):
    """ops/nms.nms_np in C++: (N, 5) float32 [x1, y1, x2, y2, score] ->
    the keep list, bit for bit nms_np's. The score order is numpy's, as
    nms_np takes it. nms_np compares its float32 overlaps with ``thresh``
    as numpy does: in float32, or in float64 for a float64 array scalar
    under numpy 2; the C++ compares with the float32 that float32
    overlaps pass exactly then (the threshold rounded up in the second
    case)."""
    dets = np.ascontiguousarray(dets, np.float32)
    if dets.ndim != 2 or dets.shape[1] != 5:
        raise ValueError("nms_np_native: dets must be (N, 5), got {}"
                         .format(dets.shape))
    order = np.ascontiguousarray(dets[:, 4].argsort()[::-1], np.int64)
    thr = np.float32(thresh)
    if (np.result_type(np.zeros(0, np.float32), thresh) != np.float32
            and float(thr) < float(thresh)):
        thr = np.nextafter(thr, np.float32(np.inf))
    keep = np.empty(len(dets), np.int64)
    n = get_nms_lib().nms_greedy_host(
        _ptr(dets, ctypes.c_float), _ptr(order, ctypes.c_int64), len(dets),
        thr, _ptr(keep, ctypes.c_int64))
    return keep[:n].tolist()
