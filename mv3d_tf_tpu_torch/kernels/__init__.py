"""Build and load the hand-written CUDA kernels of ``csrc/``.

On first use, nvcc compiles each ``csrc/*.cu`` for Hopper (``sm_90a``),
one process per source, all started together (``*.cuh`` headers are
included by the sources), and links the objects into
one shared library with a plain C interface, which is then loaded with
ctypes. The library lands in ``mv3d_tf_tpu_torch/_build/`` under a name
derived from the sources, headers and flags, so an edited source is rebuilt and an
unchanged one is reused. A missing nvcc or a failed build raises.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an error.
"""

import concurrent.futures
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# C entry points: name -> argument types (all return a cudaError_t as int)
_SIGNATURES = {
    "mv3d_roi_pool_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "mv3d_roi_pool_bf16": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "mv3d_roi_pool_s8": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "mv3d_roi_pool_bwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _F, _P),
    "mv3d_roi_pool_bwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _F, _P),
    "mv3d_stem_s2d_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mv3d_stem_s2d_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mv3d_bev_place_f32": (_P, _P, _P, _P, _L, _L, _I, _I, _P),
    "mv3d_conv3x3_s8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mv3d_conv2x2_s8": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mv3d_matmul_s8": (_P, _P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_info = {}   # seconds, library path and compiler log of the last load


def kernel_symbols():
    """The names of the __global__ functions of csrc/*.cu: how a profiler
    trace names the hand kernels."""
    names = set()
    for src in glob.glob(os.path.join(CSRC, "*.cu")):
        with open(src) as fh:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)", fh.read()))
    return sorted(names)


def nvcc_path():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _run(cmd):
    """Run one compiler command; raise with its output if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d): %s\n%s"
                           % (proc.returncode, " ".join(cmd), log))
    return log


def _build():
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, "rb") as fh:
            digest.update(fh.read())
    lib_path = os.path.join(BUILD_DIR,
                            "libmv3d_kernels_%s.so" % digest.hexdigest()[:16])
    if os.path.exists(lib_path):
        return lib_path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    objs = ["%s.%d.o" % (tmp, i) for i in range(len(sources))]
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            logs = list(pool.map(
                lambda so: _run([nvcc, *NVCC_FLAGS, "-c", "-o", so[1], so[0]]),
                zip(sources, objs)))
        logs.append(_run([nvcc, "-shared", "-o", tmp, *objs]))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    return lib_path, seconds, "".join(logs)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path, seconds, log = _build()
            lib = ctypes.CDLL(path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            build_info.update(seconds=seconds, path=path, log=log)
            _lib = lib
        return _lib


def check(err, name):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("%s: CUDA launch failed with cudaError %d"
                           % (name, err))
