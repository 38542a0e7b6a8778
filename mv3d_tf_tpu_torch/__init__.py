"""mv3d_tf_tpu_torch — the MV3D LiDAR front end, inference detector (float
and int8 PTQ) and single-frame train step in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The front end turns Velodyne scans into (601, 601, 9) BEV rasters
(``ops/bev.py``, ``tools/read_lidar.py``, ``data/blob.make_bird_view``),
which feed the detector (``eval.py``; int8 with a ``quant.py`` state) and
the train step (``train.py``).
Entry points and parameter constructors run on the card ("cuda") unless
the caller asks for another device; without a card they raise rather than
fall back to the CPU. Tensors given as inputs stay on their device.

The package mirrors the module names of the JAX package ``mv3d_tf_tpu``,
which stays the reference it is tested against: ``mv3d_tf_tpu/X.py`` has
its counterpart at ``mv3d_tf_tpu_torch/X.py``. Public functions keep the
JAX layouts (NHWC feature maps, ``(R,5)`` rois, ``(R,7,7,C)`` pooled
features, the same output dict keys), so one parameter file and one set
of inputs feed both packages.

Nothing here imports jax or any module of ``mv3d_tf_tpu``; the port keeps
its own copies (``config.py`` among them). Importing the package loads no
kernel. The CUDA kernels (``csrc/*.cu``) are compiled with nvcc on first
use (``kernels/__init__.py``).
"""

__version__ = "0.1.0"
