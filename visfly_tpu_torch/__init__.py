"""VisFly in PyTorch and CUDA: the port of ``visfly_tpu`` to one NVIDIA H100.

The package mirrors the layout and module names of ``visfly_tpu`` (``core/``,
``dynamics/``, ``scene/``, ``render/``, ``envs/``, ``policies/``, ``algos/``,
``parallel/``, ``utils/``, ``run.py``) so that each module's counterpart is
easy to find. It
imports ``torch`` and numpy, never ``jax`` and never ``visfly_tpu``; it only
reads the drone JSON data files under ``visfly_tpu/configs/drone/`` and the
experiment configs under ``visfly_tpu/exps/``, and compiles the
framework-free C++ mesh baker ``native/mesh_sdf.cpp``.

Plain tensor code is PyTorch. The ray-trace kernels are hand-written CUDA
C++ for ``sm_90a`` (``csrc/trace_analytic.cu``, ``csrc/trace_march.cu`` for
primitive scenes, ``csrc/tri_trace.cu`` for the exact triangles of imported
meshes), built with ``nvcc`` at first use and bound with ``ctypes``; on CPU
tensors their plain PyTorch versions run instead. Envs run on the CUDA card unless
built with ``device="cpu"``.
"""

__version__ = "0.1.0"
