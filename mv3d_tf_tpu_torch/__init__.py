"""mv3d_tf_tpu_torch — the MV3D inference detector in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors the module names of the JAX package ``mv3d_tf_tpu``,
which stays the reference it is tested against: ``mv3d_tf_tpu/X.py`` has
its counterpart at ``mv3d_tf_tpu_torch/X.py``. Public functions keep the
JAX layouts (NHWC feature maps, ``(R,5)`` rois, ``(R,7,7,C)`` pooled
features, the same output dict keys), so one parameter file and one set
of inputs feed both packages.

Nothing here imports jax; importing the package loads no kernel. The CUDA
kernels (``csrc/*.cu``) are compiled with nvcc on first use
(``kernels/__init__.py``).
"""

__version__ = "0.1.0"
