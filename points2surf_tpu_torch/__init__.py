"""PyTorch/CUDA port of points2surf_tpu for NVIDIA Hopper GPUs.

The JAX package ``points2surf_tpu`` is the reference; this package mirrors
its module layout (``ops/``, ``models/``, ``infer/``) and imports neither
jax nor anything from ``points2surf_tpu``. Importing it builds no kernel:
each hand-written CUDA kernel is compiled from ``csrc/`` at its first
launch on a GPU.
"""

from points2surf_tpu_torch import device  # noqa: F401  (sets fp32 numerics)
